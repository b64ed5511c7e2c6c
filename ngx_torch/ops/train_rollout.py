"""The PPO trainer's fused acting rollout: a CUDA kernel and its plain twin.

Port of ``make_pallas_train_rollout`` (``ngx/ops/pallas_rollout.py:812``,
kernel ``:1059``) in its native-reset mode.  For each env, over T steps:
LidarInFront obs -> tanh MLP actor -> Gumbel-argmax action -> env step ->
episode-cap truncation -> on done, the counter-RNG reset.  It emits the
trajectory (obs before each step, action, reward, done) and the final state.

:func:`train_rollout` is the wrapper: on a CUDA state it launches
``csrc/train_rollout.cu`` (built by :mod:`ngx_torch.ops._build`) or raises;
on a CPU state it runs :func:`train_rollout_plain`, a Python loop over T of
the plain ``vector``, ``rays``, ``models`` and ``rng`` calls with the same
semantics and the same counter-RNG bits.

Parity hazards (each also named where it is handled):

* RNG block: the stream of env ``e`` is ``(seed + (e // block)*7919, row =
  e % block)`` whatever the CUDA launch geometry (:mod:`ngx_torch.ops.rng`).
* Counters and salts: step ``t`` draws its action with ``ctr = t+1``, salt
  5, over columns ``0..A-1``, and a boundary reset at step ``t`` uses the
  same ``ctr`` (salts 2, 3, ``16+j``, 4).
* Gumbel-argmax is ``logits - log(-log(u + 1e-10) + 1e-10)`` in float32
  with a min-index tie-break (``:965-970``); the kernel's MLP sums in
  another order than torch's matmul, so the two agree except where the top
  two scores are within a few ulps.
* Boundaries: done is ``done | step_count >= cap`` (native resets restart
  the count from 0, ``:976``); a done env carries the fresh reset, and
  ``obs[t]`` is the obs of the state before step ``t`` — the reset obs
  after a boundary.
* Obs dtype: every obs value is an integer below 256, so float32 is exact;
  the wrapper returns float32 as the JAX ``run`` does (``:1223``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import spec as S
from ..core.state import EnvState
from ..vector import make_vec
from .rng import _u01, block_streams
from .tables import (check_tensor, device_tables, policy_params, seed_i32,
                     unpack_state)

SALT_ACTION = 5

def mlp_logits(x, pi_layers):
    """The policy tower's logits (tanh hidden layers), plain torch."""
    for w, b in pi_layers[:-1]:
        x = torch.tanh(F.linear(x, w, b))
    return F.linear(x, *pi_layers[-1])


def gumbel_scores(logits, seeds, ctr, rows):
    """``logits - log(-log(u + 1e-10) + 1e-10)`` in float32, with ``u`` the
    counter-RNG uniforms of ``(seed, ctr, salt 5, row, action)``
    (pallas_rollout.py:965-966)."""
    cols = torch.arange(logits.shape[-1], dtype=torch.int64,
                        device=logits.device)
    u = _u01(seeds, ctr, SALT_ACTION, rows, cols)
    return logits - torch.log(-torch.log(u + 1e-10) + 1e-10)


def gumbel_argmax(logits, seeds, ctr, rows):
    """Categorical sample by Gumbel-argmax (pallas_rollout.py:965-970);
    ``argmax`` returns the first maximum — the min-index tie-break."""
    return torch.argmax(gumbel_scores(logits, seeds, ctr, rows), dim=1)


@torch.no_grad()
def train_rollout_plain(spec, state: EnvState, pi_layers, seed: int,
                        steps: int, block: int = 128, cap: int = 100):
    """The plain twin of the kernel: same arguments and results as
    :func:`train_rollout`, any device."""
    S.check_supported(spec)
    vec = make_vec(spec, episode_cap=cap, reset_obs=True)
    B, dev = state.batch, state.device
    seeds, rows = block_streams(seed, B, block, dev)
    obs = vec.get_obs(state)
    obs_t = torch.empty((steps, B, obs.shape[1]), dtype=torch.float32,
                        device=dev)
    act = torch.empty((steps, B), dtype=torch.int32, device=dev)
    rew = torch.empty((steps, B), dtype=torch.float32, device=dev)
    done = torch.empty((steps, B), dtype=torch.bool, device=dev)
    for t in range(steps):
        ctr = t + 1
        obs_t[t] = obs.to(torch.float32)
        a = gumbel_argmax(mlp_logits(obs_t[t], pi_layers), seeds, ctr, rows)
        # vec.step: the cap truncation and the boundary reset, drawn from
        # this step's counter in the env's RNG block
        state, obs, r, d, _ = vec.step(state, a, seed, ctr, block)
        act[t], rew[t], done[t] = a.to(torch.int32), r, d
    return state, obs_t, act, rew, done


@torch.no_grad()
def train_rollout(spec, state: EnvState, pi_layers, seed: int, steps: int,
                  block: int = 128, cap: int = 100):
    """Run the acting loop for ``steps`` steps from ``state``.

    ``pi_layers``: the policy tower ``[(weight[out, in], bias[out]), ...]``
    (:meth:`ngx_torch.rl.models.ActorCritic.pi_layers`), output layer last.
    ``block``: the RNG block (128 or 256 envs, as the TPU kernel's block).

    Returns ``(state, obs[T, B, OBS_DIM] f32, action[T, B] i32,
    reward[T, B] f32, done[T, B] bool)``.  A CPU state runs the plain twin;
    a CUDA state launches the kernel on the current stream (and bumps
    ``train_rollout.launches``) or raises."""
    S.check_supported(spec)
    if spec.obs_mode != S.OBS_LIDAR_FRONT:
        raise ValueError("the acting rollout needs a lidar_in_front spec")
    dev = state.device
    if dev.type == "cpu":
        return train_rollout_plain(spec, state, pi_layers, seed, steps,
                                   block, cap)
    if dev.type != "cuda":
        raise ValueError(f"no acting rollout for device {dev}")
    from ._build import load_library
    out = launch(load_library(), spec, state, pi_layers, seed, steps, block,
                 cap, torch.cuda.current_stream(dev).cuda_stream)
    train_rollout.launches += 1
    return out


train_rollout.launches = 0

# CUDA threads per thread block; it changes no result (the RNG block is
# logical).  32 measured fastest of 32/64/128/256 at B=8192, T=64 (PERF.md)
THREADS = 32


def launch(lib, spec, state: EnvState, pi_layers, seed, steps, block, cap,
           stream):
    """Check every tensor, allocate the outputs and call the library's
    ``ngx_train_rollout`` once (see :func:`train_rollout`)."""
    dev = state.device
    B, T = state.batch, int(steps)
    H, I = spec.map_size, spec.n_items
    HW = H * H
    dims, params = policy_params(spec, pi_layers, dev)
    tab = device_tables(spec, dims, dev)
    obs_dim = dims[0]

    i32 = torch.int32
    ir_in = torch.stack(
        [state.agent[:, 0], state.agent[:, 1], state.facing, state.selected,
         state.step_count, state.last_action, state.last_done.to(i32)],
        dim=1).to(i32).contiguous()
    fr_in = torch.stack([state.last_reward, state.last_cost],
                        dim=1).contiguous()
    map_in = state.map.contiguous()
    inv_in = state.inventory.contiguous()
    check_tensor(map_in, "map", i32, (B, HW), dev)
    check_tensor(inv_in, "inventory", i32, (B, I), dev)
    check_tensor(fr_in, "last_reward/last_cost", torch.float32, (B, 2), dev)

    maxw = max(dims)
    scratch = torch.empty((2 * maxw * B,), dtype=torch.float32, device=dev)
    outs = (torch.empty_like(map_in), torch.empty_like(ir_in),
            torch.empty_like(fr_in), torch.empty_like(inv_in),
            torch.empty((T, B, obs_dim), dtype=torch.float32, device=dev),
            torch.empty((T, B), dtype=i32, device=dev),
            torch.empty((T, B), dtype=torch.float32, device=dev),
            torch.empty((T, B), dtype=torch.bool, device=dev))
    rc = lib.ngx_train_rollout(
        tab.data_ptr(), tab.numel(), map_in.data_ptr(), ir_in.data_ptr(),
        fr_in.data_ptr(), inv_in.data_ptr(), params.data_ptr(),
        params.numel(), seed_i32(seed), B, T, int(block), int(cap), THREADS,
        HW, I, scratch.data_ptr(), maxw, *[o.data_ptr() for o in outs],
        stream)
    if rc != 0:
        raise RuntimeError("train_rollout kernel launch failed: "
                           + lib.ngx_error_string(rc).decode())
    obs, act, rew, done = outs[4:]
    return unpack_state(*outs[:4]), obs, act, rew, done


def compare_rollouts(a, b):
    """Hold two acting rollouts from the same inputs against each other.

    ``a``, ``b``: ``(state, obs, action, reward, done)`` tuples.  Per env,
    everything is compared exactly up to that env's first action mismatch:
    obs up to and including that step, reward and done before it, and the
    final state of envs with no mismatch.  Returns ``(first[B], bad)``:
    each env's first mismatching step (T where none) and a list of what
    disagreed inside the compared prefixes (empty when they agree)."""
    sa, oa, aa, ra, da = a
    sb, ob, ab, rb, db = b
    T = aa.shape[0]
    mism = (aa != ab)
    first = torch.where(mism.any(0), mism.to(torch.int8).argmax(0),
                        torch.full_like(mism[0], T, dtype=torch.int64))
    steps = torch.arange(T, device=aa.device)[:, None]
    before = steps < first[None, :]
    bad = []
    if not ((oa == ob).all(-1) | ~(steps <= first[None, :])).all():
        bad.append("obs")
    for name, x, y in (("reward", ra, rb), ("done", da, db)):
        if not ((x == y) | ~before).all():
            bad.append(name)
    clean = first == T
    for name, x in sa.__dict__.items():
        y = getattr(sb, name)
        if not (x[clean] == y[clean]).all():
            bad.append(f"state.{name}")
    return first, bad
