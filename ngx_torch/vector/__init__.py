"""Batched environments with auto-reset — the port of ``ngx/vector``'s
``make_vec`` (``ngx/vector/__init__.py:39``), ``Trajectory`` (``:31``) and
``throughput_fn`` (``:119``).

The batch is one :class:`~ngx_torch.core.state.EnvState` with a leading env
axis.  ``make_vec`` builds it in one of two draw forms:

* ``rng='threefry'``: :class:`KeyedVecEnv`, ngx's ``VecEnv`` on ngx's keys
  (:mod:`ngx_torch.ops.threefry`): ``reset(keys)``, ``step(state, actions,
  keys)`` and ``rollout(state, key, policy, T)`` take ngx's arguments, a
  done env's fresh state is ngx's native reset
  (:func:`~ngx_torch.core.reset.make_reset`) on its key, and the states and
  obs equal ngx's bit for bit;
* ``rng='counter'`` (the default): :class:`VecEnv`, whose resets are the
  counter-RNG reset (:mod:`ngx_torch.core.reset`), a draw addressed by
  ``(seed, ctr, row)``: :meth:`VecEnv.reset` takes a seed, :meth:`VecEnv.
  step` the acting loop's ``seed``, step counter and RNG block, and a done
  env's fresh state is the one the CUDA kernel draws for the same env at
  the same step — the kernels' twins' form.

:func:`throughput_fn` with ``rng='threefry'`` is ngx's scan on ngx's keys,
with ngx's three action draws (``action_rng='threefry'`` alone names it).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.reset import (ResetTables, native_reset_state,
                          native_reset_where, reset_rows)
from ..core.state import make_state_packers
from ..core.step import make_step
from ..ops import threefry as TF
from ..ops.rng import _randint, block_streams, hash_actions  # noqa: F401
from ..ops.rollout import ACTION_RNGS, SALT_PRNG_ACTION
from ..ops.tables import resolve_device
from ..utils import debug, trace

# ngx's throughput_fn action draws (ngx/vector/__init__.py:119-200), on keys
KEYED_ACTION_RNGS = ("threefry", "hash", "fixed")


class Trajectory(NamedTuple):
    """Time-major stacked rollout output (T leading, then batch)."""
    obs: object
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    step_costs: torch.Tensor


class VecEnv:
    """``make_vec(spec, episode_cap=..., reset_obs=...)``'s batched env.

    ``step`` auto-resets finished envs: when an env reports done, its carried
    state is a fresh reset draw.  ``episode_cap`` adds the trainer's
    time-limit truncation: envs whose post-step ``step_count`` reaches the
    cap read as done and auto-reset.  With ``reset_obs=False`` the returned
    obs is the terminal observation; ``reset_obs=True`` (SB2-VecEnv
    semantics, what the reference trains under, reference
    tests/train.py:104-122) returns the reset observation at a boundary, so
    ``obs == get_obs(carried_state)`` on every step.  Built under
    ``NGX_DEBUG=1``, its step and every reset draw check their states'
    invariants (:mod:`ngx_torch.utils.debug`), as ngx's ``make_vec`` over
    ``make_step`` and ``make_reset`` does."""

    def __init__(self, spec, episode_cap: Optional[int] = None,
                 reset_obs: bool = False, mesh=None):
        self.spec = spec
        self.episode_cap = episode_cap
        self.reset_obs = reset_obs
        self.mesh = mesh
        self._step = make_step(spec, with_obs=False)
        self.get_obs = self._step.get_obs
        self._reset_tables = ResetTables(spec)
        self._debug = debug.enabled()

    def _reset_rows(self, seeds, ctr, rows):
        state = reset_rows(self._reset_tables, seeds, ctr, rows)
        if self._debug:
            debug.kernel_asserts(self.spec, state, "reset")
        return state

    def _streams(self, seed: int, n: int, block: Optional[int], device):
        """The streams of the ``n`` envs held here: under a mesh (an
        :class:`ngx_torch.parallel.EnvMesh`) the rank's rows of the global
        batch of ``n * size`` envs, in blocks of ``block`` (the global batch
        by default)."""
        size = 1 if self.mesh is None else self.mesh.size
        offset = 0 if self.mesh is None else self.mesh.rank * n
        return block_streams(seed, n, block or n * size, device,
                             offset=offset)

    def reset(self, seed: int, batch: int, block: Optional[int] = None,
              device=None):
        """``(state, obs)``: ``batch`` fresh states, the counter reset at
        ``ctr = 0`` of the RNG streams ``(seed + blk*7919, env % block)``
        (one block of ``batch`` envs by default).  Under a mesh ``batch`` is
        the global batch and the state the rank's rows of it, on the mesh's
        device.  ``device`` defaults to the card and raises where there is
        none."""
        if self.mesh is not None:
            lo, hi = self.mesh.rows(batch)
            batch, device = hi - lo, device or self.mesh.device
        seeds, rows = self._streams(seed, batch, block,
                                    resolve_device(device or "cuda"))
        state = self._reset_rows(seeds, 0, rows)
        return state, self.get_obs(state)

    def step(self, state, actions, seed: int, ctr: int,
             block: Optional[int] = None):
        """One step of every env; a done env restarts from the reset draw
        ``(seed + blk*7919, ctr, env % block)``, ``env`` its global index
        under a mesh."""
        new_state, _, reward, done, info = self._step(state, actions)
        if self.episode_cap is not None:
            done = done | (new_state.step_count >= self.episode_cap)
        carried = new_state
        idx = done.nonzero()[:, 0]
        if idx.numel():
            seeds, rows = self._streams(seed, state.batch, block,
                                        state.device)
            fresh = self._reset_rows(seeds[idx], ctr, rows[idx])
            carried = new_state.put(idx, fresh)
        obs = self.get_obs(carried if self.reset_obs else new_state)
        return carried, obs, reward, done, info

    def rollout(self, state, seed: int, policy, T: int,
                block: Optional[int] = None):
        """``(state, Trajectory)`` after ``T`` steps from ``state``; step
        ``t`` has ``ctr = t + 1``, and its resets are :meth:`step`'s under
        ``seed`` and ``block``.  ``policy(ctr, state) -> actions[B]``;
        ``None`` draws uniform actions on the counter RNG,
        ``_randint(seed, ctr, salt 1, row, col 0) % A`` — the 'prng'
        kernel's, so from :meth:`reset`'s state under the same seed and
        block the rollout is :func:`throughput_fn`'s."""
        if T < 1:
            raise ValueError(f"a rollout of {T} steps")
        B = state.batch
        seeds, rows = self._streams(seed, B, block, state.device)
        col0 = torch.zeros((1,), dtype=torch.int64, device=state.device)
        out = []
        for t in range(T):
            ctr = t + 1
            if policy is None:
                actions = _randint(seeds, ctr, SALT_PRNG_ACTION, rows, col0,
                                   self.spec.n_actions)[:, 0]
            else:
                actions = policy(ctr, state)
            state, obs, reward, done, info = self.step(state, actions, seed,
                                                       ctr, block)
            out.append((obs, actions.to(torch.int32), reward, done,
                        info.step_cost))
        return state, _stack_trajectory(out)


class KeyedVecEnv:
    """``make_vec(spec, episode_cap=..., reset_obs=..., rng='threefry')``:
    ngx's ``VecEnv`` (``ngx/vector/__init__.py:39-116``) on ngx's keys, on
    the device of the keys and states it is given.  A key batch is an int64
    ``[B, 2]`` tensor of ``jax.random.key_data`` words
    (:mod:`ngx_torch.ops.threefry`).  ``episode_cap`` and ``reset_obs``
    are :class:`VecEnv`'s (and ngx's).  A done env's carried state is its
    row of ngx's native reset over the step's keys; only the done rows are
    drawn, since a row's reset depends on its key alone.  Built under
    ``NGX_DEBUG=1``, its step and every reset draw check their states'
    invariants."""

    def __init__(self, spec, episode_cap: Optional[int] = None,
                 reset_obs: bool = False):
        self.spec = spec
        self.episode_cap = episode_cap
        self.reset_obs = reset_obs
        self._step = make_step(spec, with_obs=False)
        self.get_obs = self._step.get_obs
        self._reset_tables = ResetTables(spec)
        self._debug = debug.enabled()

    def _reset_state(self, keys):
        state = native_reset_state(self._reset_tables, keys)
        if self._debug:
            debug.kernel_asserts(self.spec, state, "reset")
        return state

    def reset(self, keys):
        """``(state, obs)``: ``jax.vmap(make_reset(spec))(keys)``, on the
        keys' device."""
        keys = torch.as_tensor(keys).to(torch.int64)
        if keys.dim() != 2 or keys.shape[1] != 2:
            raise ValueError(f"reset takes keys [B, 2], got "
                             f"{tuple(keys.shape)}")
        state = self._reset_state(keys)
        return state, self.get_obs(state)

    def _reset_where(self, state, done, keys=None, parent=None, offset=0):
        """The carried state (:func:`~ngx_torch.core.reset.
        native_reset_where`); under ``NGX_DEBUG`` its reset rows are
        checked."""
        carried = native_reset_where(self._reset_tables, state, done, keys,
                                     parent, offset)
        if self._debug:
            idx = done.nonzero()[:, 0]
            if idx.numel():
                debug.kernel_asserts(self.spec, carried.take(idx), "reset")
        return carried

    def _advance(self, state, actions, keys=None, parent=None, offset=0):
        new_state, _, reward, done, info = self._step(state, actions)
        if self.episode_cap is not None:
            done = done | (new_state.step_count >= self.episode_cap)
        if trace.recording():
            # one host read, only while a profiler session records
            n = int(done.sum())
            carried = new_state
            if n:
                with trace.span("ngx_torch.eval.reset") as reset:
                    carried = self._reset_where(new_state, done, keys,
                                                parent, offset)
                    reset.count("envs", n)
                    reset.count("kernel_envs",
                                n if new_state.device.type == "cuda" else 0)
        else:
            carried = self._reset_where(new_state, done, keys, parent,
                                        offset)
        # the terminal obs unless reset_obs: the carried state is a new
        # batch, so the stepped one is intact
        obs = self.get_obs(carried if self.reset_obs else new_state)
        return carried, obs, reward, done, info

    def step_rows(self, state, actions, parent, offset: int = 0):
        """:meth:`step` with the reset keys drawn from ``parent``, the
        step's reset key (int64 ``[2]``): a done row ``b`` resets on
        ``split_at(parent, b + offset)``, its row of ``split(parent, N)``
        (ngx splits it over the whole batch; ``offset``: a shard's first
        row).  On the card one launch of the reset kernel writes the
        carried state, with no host read.  While a profiler session
        records, a step with done rows opens the span
        ``ngx_torch.eval.reset`` (evaluation's layer, which this env
        serves), counting the ``envs`` reset and the ``kernel_envs``, those
        the kernel reset."""
        return self._advance(state, actions, parent=parent, offset=offset)

    def step(self, state, actions, keys):
        """``(state, obs, reward, done, info)``: one step of every env; a
        done env (or one at the cap) carries its row of
        ``make_reset(keys)``.  The obs is the terminal one, or with
        ``reset_obs`` the carried state's."""
        keys = torch.as_tensor(keys).to(device=state.device,
                                        dtype=torch.int64)
        return self._advance(state, actions, keys=keys)

    def rollout(self, state, key, policy, T: int):
        """``(state, Trajectory)`` after ``T`` steps, ngx's scan: ``split(
        key, T)``; at each step ``k_act, k_reset = split(key_t)``, the
        actions ``randint(k_act, (B,), 0, A)`` (``policy=None``) or
        ``policy(k_act, state)``, then :meth:`step` over ``split(k_reset,
        B)``."""
        if T < 1:
            raise ValueError(f"a rollout of {T} steps")
        B, dev = state.batch, state.device
        keys = TF.split(torch.as_tensor(key).to(dev, torch.int64), T)
        out = []
        for t in range(T):
            k_act, k_reset = TF.split(keys[t])
            if policy is None:
                actions = TF.randint(k_act, (B,), 0, self.spec.n_actions)
            else:
                actions = policy(k_act, state)
            state, obs, reward, done, info = self.step_rows(
                state, actions, k_reset)
            out.append((obs, actions.to(torch.int32), reward, done,
                        info.step_cost))
        return state, _stack_trajectory(out)

    def scan(self, state, key, T: int, batch: Optional[int] = None,
             offset: int = 0, auto_reset: bool = True, packers=None,
             action_rng: str = "threefry"):
        """``(state, reward_sum, done_count)`` after ``T`` random-action
        steps, :meth:`rollout`'s draws with nothing stored per step (ngx's
        benchmark scans, ``ngx/vector/__init__.py:159-200``): ``split(key,
        T)``; at each step ``k_act, k_reset = split(key_t)``, the actions
        rows ``[offset, offset + B)`` of ngx's ``action_rng`` draw over the
        global batch — ``'threefry'`` ``randint(k_act, (batch,), 0, A)``,
        ``'hash'`` :func:`hash_actions` of the global env index and the
        step, ``'fixed'`` action 0 (``k_act`` unused by the last two, as in
        ngx) — and a done env ``b`` (with ``auto_reset``) takes row
        ``offset + b`` of the native reset over ``split(k_reset, batch)``.
        ``batch`` is the global batch (``B`` by default): a shard takes its
        rows of the global draws.  ``packers`` (``make_state_packers``'
        ``(pack, unpack)``) carries the state packed between steps, as
        ngx's packed scans do.  The reward sum is float32, one ``sum`` a
        step; the done count int64."""
        if action_rng not in KEYED_ACTION_RNGS:
            raise ValueError(f"action_rng {action_rng!r} is not one of "
                             f"{KEYED_ACTION_RNGS}")
        B, dev = state.batch, state.device
        batch = B if batch is None else batch
        n_actions = self.spec.n_actions
        pack, unpack = packers or (None, None)
        carry = pack(state) if pack else state
        r_sum = torch.zeros((), dtype=torch.float32, device=dev)
        d_sum = torch.zeros((), dtype=torch.int64, device=dev)
        keys = TF.split(torch.as_tensor(key).to(dev, torch.int64), T)
        for t, key_t in enumerate(keys):
            state = unpack(carry) if pack else carry
            k_act, k_reset = TF.split(key_t)
            if action_rng == "threefry":
                actions = TF.randint(k_act, (batch,), 0, n_actions)
            elif action_rng == "hash":
                actions = hash_actions(batch, t, n_actions, dev)
            else:
                actions = torch.zeros((batch,), dtype=torch.int64,
                                      device=dev)
            state, _, reward, done, _ = self._step(
                state, actions[offset:offset + B])
            if self.episode_cap is not None:
                done = done | (state.step_count >= self.episode_cap)
            if auto_reset:
                state = self._reset_where(state, done, parent=k_reset,
                                          offset=offset)
            carry = pack(state) if pack else state
            r_sum = r_sum + reward.sum()
            d_sum = d_sum + done.sum()
        return (unpack(carry) if pack else carry), r_sum, d_sum


def _stack_trajectory(out):
    obs, actions, rewards, dones, costs = zip(*out)
    if isinstance(obs[0], dict):
        obs = {k: torch.stack([o[k] for o in obs]) for k in obs[0]}
    else:
        obs = torch.stack(obs)
    return Trajectory(obs, torch.stack(actions), torch.stack(rewards),
                      torch.stack(dones), torch.stack(costs))


RNGS = ("counter", "threefry")


def make_vec(spec, *, episode_cap: Optional[int] = None,
             reset_obs: bool = False, rng: str = "counter"):
    """ngx's ``make_vec``: :class:`KeyedVecEnv` on ngx's keys for
    ``rng='threefry'``, :class:`VecEnv` on the counter RNG for
    ``'counter'`` (the default)."""
    if rng not in RNGS:
        raise ValueError(f"rng {rng!r} is not one of {RNGS}")
    cls = KeyedVecEnv if rng == "threefry" else VecEnv
    return cls(spec, episode_cap=episode_cap, reset_obs=reset_obs)


def throughput_fn(spec, batch: int, steps: int, action_rng: str = "counter",
                  auto_reset: bool = True, packed: bool = False,
                  device="cuda", rng: Optional[str] = None):
    """``run(seed) -> (state, mean_reward)``: ``steps`` random-action steps of
    ``batch`` auto-resetting envs with nothing stored per step — the
    env-stepping benchmark (BASELINE.json's env-steps/s metric).  The mean
    is over ``batch * steps`` env-steps.  ``device`` defaults to the card and
    raises where there is none.

    ``rng`` names where the start states and the resets come from, as
    :func:`make_vec`'s does, and ``action_rng`` the actions' draw; ngx's
    ablations (``ngx/vector/__init__.py:119-204``), one at a time on the
    kernel and in any mix on ngx's keys, as ngx's: ``'hash'`` is ngx's counter hash of the env index and the step
    (:func:`hash_actions`, bit for bit), ``'fixed'`` action 0,
    ``auto_reset=False`` lets done envs step on from their terminal state,
    ``packed=True`` gives the same state bit for bit through
    :func:`~ngx_torch.core.state.make_state_packers`' words.  ``rng``
    defaults to ``'threefry'`` where ``action_rng`` is ``'threefry'`` and
    to ``'counter'`` otherwise, so each existing call keeps its path.

    ``rng='counter'`` is the ``'prng'`` mode of
    :func:`ngx_torch.ops.rollout.make_rollout`: on a CUDA ``device`` the
    rollout kernel, on the CPU its plain twin.  ``action_rng='counter'``
    (the default) draws the action of step ``t`` as ``_randint(seed, t+1,
    salt 1, row, 0) % A``, and every reset is the counter reset, in RNG
    blocks of 512 envs (or the whole batch where it is not a multiple of
    512); ``'hash'`` and ``'fixed'`` are the kernel's variants; packed has
    the kernel write its final state packed.

    ``rng='threefry'`` is ngx's scan on ngx's keys, plain torch (no kernel:
    it is XLA in ngx): ``run(key)`` takes a key (a
    :func:`~ngx_torch.ops.threefry.key` tensor, or a seed for
    ``key(seed)``) and gives ngx's ``throughput_fn(spec, batch, steps,
    action_rng=..., auto_reset=..., packed=...)(key)``, final state bit for
    bit (:func:`_threefry_throughput`), with ``action_rng`` one of ngx's
    ``'threefry'``, ``'hash'`` and ``'fixed'``."""
    if rng is None:
        rng = "threefry" if action_rng == "threefry" else "counter"
    if rng not in RNGS:
        raise ValueError(f"rng {rng!r} is not one of {RNGS}")
    if rng == "threefry":
        if action_rng not in KEYED_ACTION_RNGS:
            raise ValueError(
                f"action_rng {action_rng!r}: ngx's keyed scan draws actions "
                f"with one of {KEYED_ACTION_RNGS}")
        return _threefry_throughput(spec, batch, steps, action_rng,
                                    auto_reset, packed, device)
    from ..ops.rollout import make_rollout

    if action_rng not in ACTION_RNGS:
        raise ValueError(
            f"action_rng {action_rng!r}: the port draws actions with "
            f"'counter' (its default, the counter RNG of the kernel), "
            f"'threefry' (ngx's default, on ngx's keys), 'hash' or 'fixed'")
    block = 512 if batch % 512 == 0 else batch
    run = make_rollout(spec, batch, steps, block=block, action_source="prng",
                       device=device, action_rng=action_rng,
                       auto_reset=auto_reset, packed=packed)

    def throughput(seed: int):
        state, mean_reward, _ = run(seed)
        return state, mean_reward

    return throughput


def _threefry_throughput(spec, batch, steps, action_rng, auto_reset, packed,
                         device):
    """ngx's ``throughput_fn`` scan (``ngx/vector/__init__.py:159-200``) in
    its draw order: ``k0, k1 = split(key)``; the start states are
    ``make_reset`` over ``split(k0, batch)``; step ``t`` splits key ``t`` of
    ``split(k1, steps)`` into ``k_act, k_reset``, draws the actions
    (``randint(k_act, (batch,), 0, A)`` for ``'threefry'``, the hash of
    ``t`` or action 0) and runs the plain step; where an env
    is done (``auto_reset``), its state is its row of ``make_reset`` over
    ``split(k_reset, batch)`` (drawn for the done rows only: a row's reset
    depends on its key alone).  ``packed`` carries the state in ngx's packed
    words between steps, as ngx's scan does (:meth:`KeyedVecEnv.scan`).
    The reward sum is float32, one ``sum`` a step, as ngx's; its mean is the product with the float32
    reciprocal of ``batch * steps``, since XLA rewrites ngx's division by
    that constant so (the two differ in the last bit on some sums)."""
    dev = resolve_device(device)
    vec = KeyedVecEnv(spec)
    inv_n = torch.tensor(np.float32(1) / np.float32(batch * steps),
                         device=dev)
    packers = make_state_packers(spec)[:2] if packed else None

    def throughput(key):
        k0, k1 = TF.split(TF.as_key(key, dev))
        state, _ = vec.reset(TF.split(k0, batch))
        state, r_sum, _ = vec.scan(state, k1, steps, auto_reset=auto_reset,
                                   packers=packers, action_rng=action_rng)
        return state, r_sum * inv_n

    return throughput
