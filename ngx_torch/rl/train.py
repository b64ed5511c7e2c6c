"""PPO training — the port of ``ngx/rl/train.py`` (``PPOConfig``, ``make_ppo_core``,
``make_train``, ``train``).

Algorithmic surface as in the JAX package (SB2 PPO2 defaults, reference
``tests/train.py:122,135``: clipped surrogate, GAE, minibatch epochs).  The
acting loop is :func:`ngx_torch.ops.train_rollout.train_rollout`: the CUDA
kernel for a CUDA device, its plain twin on the CPU.  ``logp`` and the value
are recomputed over the emitted obs outside the kernel, as
``train.py:418-421`` does.  A spec whose reset has edits (the novelty
percent-fills, the v3 wall coin, the Pogostick-v0 tap) takes the kernel's
pool-reset mode, as ngx's trainer does (``train.py:330-346``): each step
draws a fresh pool of ``B * POOL_SLOTS`` counter resets
(:func:`ngx_torch.ops.rollout.pool_reset`, the rollout kernel at T 0 on the
card) and a boundary restores the env's next slot.

``rollout_backend='xla'`` is the unfused acting loop, the port of ngx's
``rollout_xla`` (``train.py:285-310``), for the A/B against the kernel: T
steps of the ``ActorCritic`` forward, ``categorical`` on ngx's keys and
:meth:`ngx_torch.vector.KeyedVecEnv.step_rows`, each a few torch calls on
the same device.  It is taken only when asked for, never as a fallback.

Parity hazards with ``ngx``:

* ``adv.std()`` in JAX is the population std; torch's is unbiased by
  default, so the loss uses ``unbiased=False``;
* ``optax.clip_by_global_norm`` scales by ``max_norm / ||g||`` with no
  epsilon, unlike ``torch.nn.utils.clip_grad_norm_``: the clip is written
  out in :func:`clip_by_global_norm`;
* the draws: the trainer takes ngx's keys and draws as ngx does
  (:mod:`ngx_torch.ops.threefry`): the start states, the parameters
  (:meth:`ActorCritic.from_key`), the kernel and pool seeds, the unfused
  loop's actions and resets and the epochs' permutations are ngx's from
  the same key; only float rounding in the MLP and the Adam step
  separates the two runs.  The counter RNG lives in the kernels and their
  plain twins only, which take the seeds drawn from the key.

Under a mesh (:mod:`ngx_torch.parallel`, ngx's ``make_train(cfg, mesh)``)
each rank acts on its shard of the env batch and updates shard-locally, as
ngx's ``shard_map`` does (``train.py:97-105``, ``:436-459``): it permutes
and minibatches its own ``T*B/W`` samples, the advantage moments and the
gradients are all-reduced per minibatch, and the metrics once a step.  No
state or trajectory leaves its rank.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import spec as S
from ..core.step import make_step
from ..ops import threefry as TF
from ..ops.rollout import pool_reset
from ..ops.tables import lidar_obs_dim, resolve_device
from ..ops.train_rollout import train_rollout
from ..presets import make_spec
from ..transforms import lidar_in_front
from ..utils import debug, trace
from ..vector import KeyedVecEnv
from .models import ActorCritic

_SEED_HI = 2 ** 31 - 1   # seeds drawn in [0, int32 max), as jax.random.randint
# the acting backends: 'auto' and 'pallas' run the kernel, 'xla' the
# unfused loop (ngx's names)
BACKENDS = ("auto", "xla", "pallas")
# pool slots R per env (ngx/rl/train.py:334-341): 4 covers the trainer
# shapes; an env with more boundaries in one rollout cycles its slots
POOL_SLOTS = 4


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    env_id: str = "NovelGridworld-Pogostick-v1"
    num_envs: int = 1024
    rollout_steps: int = 64
    epochs: int = 4
    num_minibatches: int = 8
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 2.5e-4
    max_grad_norm: float = 0.5
    hidden: tuple = (64, 64)
    episode_cap: int = 100      # reference eval cap (enjoy.py:87,107)
    # solve-shaped reward: -1/step and +reward_done only on a goal
    # termination (see ngx/rl/train.py:46-52)
    solve_shaped: bool = False
    # BC anchor: bc_coef * cross-entropy(policy, expert action) over the
    # make_train(..., bc_data=(obs, actions)) dataset, added to every
    # minibatch loss
    bc_coef: float = 0.0
    # minibatch shuffle: 'permutation' (uniform per epoch) or 'affine'
    # (i -> (A*i + r) mod N, A odd; power-of-two N only)
    shuffle: str = "permutation"


class TrainState(NamedTuple):
    model: ActorCritic
    opt: torch.optim.Optimizer


def pick_trainer_block(B: int) -> int:
    """The acting kernel's RNG block: 256 envs when the batch allows it,
    else 128 — the block ngx's trainer picks (``train.py:76-78``), so the
    same seed gives the same random streams."""
    return 256 if B % 256 == 0 else 128


def reset_source(spec) -> str:
    """``'pool'`` for a spec whose reset has edits (novelty percent-fills,
    the v3 wall coin, the Pogostick-v0 tap), else ``'native'``: ngx's rule
    (``train.py:330-332``)."""
    plain = (not spec.reset_edits and not spec.reset_wall_coin
             and not spec.reset_place_tap)
    return "native" if plain else "pool"


def acting_backend(rollout_backend: str) -> str:
    """``'pallas'`` (the kernel) for ``'auto'`` and ``'pallas'``, ``'xla'``
    (the unfused loop) for ``'xla'``; raises for any other name.  Under
    ``NGX_DEBUG=1`` the kernel raises ``RuntimeError``, as ngx's
    ``make_pallas_train_rollout`` does (``:871-874``): ``'xla'`` is the path
    that runs with the asserts."""
    if rollout_backend not in BACKENDS:
        raise ValueError(f"rollout_backend {rollout_backend!r} is not one "
                         f"of {BACKENDS}")
    if rollout_backend == "xla":
        return "xla"
    debug.refuse_kernel("rollout_backend='xla'")
    return "pallas"


@torch.no_grad()
def rollout_unfused(model, env_step, state, obs, gumbel):
    """The unfused acting loop under given noise (ngx's XLA chain step,
    ``ngx/rl/curriculum.py:315-341``): for each of the ``T`` steps of
    ``gumbel`` (float32 ``[T, B, A]``, ``jax.random.gumbel`` of the step's
    key), the argmax of ``model``'s logits on ``obs`` plus the step's
    noise (``jax.random.categorical``'s draw), then ``env_step(state,
    actions, t) -> (state, obs, reward, done)``.  Returns ``(state, obs_t,
    action, reward, done, last_obs)``, the kernel's trajectory layout."""
    steps, B, dev = gumbel.shape[0], state.batch, state.device
    obs_t = torch.empty((steps,) + tuple(obs.shape), dtype=torch.float32,
                        device=dev)
    act = torch.empty((steps, B), dtype=torch.int32, device=dev)
    rew = torch.empty((steps, B), dtype=torch.float32, device=dev)
    done = torch.empty((steps, B), dtype=torch.bool, device=dev)
    for t in range(steps):
        obs_t[t] = obs
        logits, _ = model(obs_t[t])
        a = torch.argmax(logits + gumbel[t], dim=1)
        state, obs, rew[t], done[t] = env_step(state, a, t)
        obs = obs.to(torch.float32)
        act[t] = a.to(torch.int32)
    return state, obs_t, act, rew, done, obs


@torch.no_grad()
def rollout_keyed(model, vec: KeyedVecEnv, state, obs, key, steps: int,
                  batch: int, offset: int):
    """ngx's ``rollout_xla`` on ngx's keys (``train.py:285-310``):
    ``split(key, steps)``; at step ``t``, ``k_act, k_reset = split(key_t)``,
    ``categorical(k_act, logits)`` on ``model``'s logits, then ``vec``'s
    step with the done rows' keys of ``split(k_reset, batch)``.  ``batch``
    is the global batch and ``offset`` the first of ``state``'s rows in it
    (0 unsharded): under a mesh the rank takes its rows of the global
    draws.  Returns ``(state,
    obs_t, action, reward, done, last_obs)``, :func:`rollout_unfused`'s
    layout."""
    B, dev = state.batch, state.device
    keys = TF.split(torch.as_tensor(key).to(dev, torch.int64), steps)
    obs_t = torch.empty((steps,) + tuple(obs.shape), dtype=torch.float32,
                        device=dev)
    act = torch.empty((steps, B), dtype=torch.int32, device=dev)
    rew = torch.empty((steps, B), dtype=torch.float32, device=dev)
    done = torch.empty((steps, B), dtype=torch.bool, device=dev)
    for t in range(steps):
        obs_t[t] = obs
        logits, _ = model(obs_t[t])
        k_act, k_reset = TF.split(keys[t])
        g = TF.gumbel(k_act, (batch, logits.shape[-1]))[offset:offset + B]
        a = torch.argmax(g + logits, dim=-1)
        state, obs, rew[t], done[t], _ = vec.step_rows(state, a, k_reset,
                                                        offset)
        obs = obs.to(torch.float32)
        act[t] = a.to(torch.int32)
    return state, obs_t, act, rew, done, obs


def draw_seed(key) -> int:
    """ngx's acting and pool seed, ``randint(key, (), 0, 2^31 - 1)``, as
    a Python int (``train.py:397-409``); from a host key, no device read."""
    return int(TF.randint(key, (), 0, _SEED_HI))


def epoch_perms(cfg: PPOConfig, key, n: int, device):
    """The epochs' minibatch orders of ngx's update (``train.py:157-199``):
    one per key of ``split(key, cfg.epochs)``, ``permutation(key_e, n)``
    (on ``device``, the epochs in one batched call), or for
    ``shuffle='affine'`` ``(i * a + r) % n`` with
    ``a = 2 * randint(key_e, (), 0, n // 2) + 1`` and ``r = randint(
    fold_in(key_e, 1), (), 0, n)`` (drawn on ``key``'s device)."""
    keys = TF.split(key, cfg.epochs)
    if cfg.shuffle != "affine":
        return list(TF.permutation(keys.to(device), n))
    if n & (n - 1):
        raise ValueError("affine shuffle needs power-of-two num_envs*rollout")
    out = []
    for k_e in keys:
        a = int(TF.randint(k_e, (), 0, n // 2)) * 2 + 1
        r = int(TF.randint(TF.fold_in(k_e, 1), (), 0, n))
        out.append((torch.arange(n, device=device) * a + r) % n)
    return out


def clip_by_global_norm(params, max_norm: float):
    """``optax.clip_by_global_norm``: where ``||g|| >= max_norm`` every
    gradient becomes ``(g / ||g||) * max_norm`` — no epsilon."""
    grads = [p.grad for p in params if p.grad is not None]
    g_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    trigger = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(trigger, g, (g / g_norm) * max_norm))


def make_ppo_core(cfg: PPOConfig, bc_data=None, mesh=None):
    """The PPO math, independent of how the rollout is produced:
    ``gae(values, rewards, dones, last_value) -> (adv, target)`` and
    ``update(ts, (obs, action, logp, adv, target), perms) -> (pg_loss,
    v_loss, entropy)`` each ``[epochs, num_minibatches]``.  ``perms``: one
    index permutation of the ``N`` samples per epoch (:func:`epoch_perms`).
    ``update`` takes ``generator=None`` only, the keyword of the removed
    counter form that ``portbench/tests`` still passes on.

    ``mesh`` (an :class:`~ngx_torch.parallel.EnvMesh`): ``update`` runs
    shard-local, ngx's ``axis_name`` path (``train.py:97-105``): the batch
    is the rank's samples; per minibatch the advantage moments are
    all-reduced and normalized as ngx's ``pmean`` form (``:139-142``:
    ``gm``, ``gsq``, ``sqrt(max(gsq - gm^2, 0))``, not ``adv.std()``),
    and the gradients are averaged by one all-reduce of one flat bucket
    before the global-norm clip (optax's chain order); the loss terms
    returned are averaged over the ranks by one all-reduce at the end."""
    W = 1 if mesh is None else mesh.size

    def gae(values, rewards, dones, last_value):
        adv_next = torch.zeros_like(last_value)
        v_next = last_value
        advs = torch.empty_like(values)
        for t in reversed(range(values.shape[0])):
            nonterm = 1.0 - dones[t].to(torch.float32)
            delta = rewards[t] + cfg.gamma * v_next * nonterm - values[t]
            adv_next = delta + cfg.gamma * cfg.gae_lambda * nonterm * adv_next
            advs[t] = adv_next
            v_next = values[t]
        return advs, advs + values

    def loss_fn(model, obs, action, old_logp, adv, target):
        logits, value = model(obs.to(torch.float32))
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, action.long()[:, None])[:, 0]
        ratio = torch.exp(logp - old_logp)
        if mesh is None:
            adv_n = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
        else:
            # global-minibatch moments from equal-sized shards
            mom = mesh.all_reduce(torch.stack(
                [adv.mean(), torch.square(adv).mean()]), "moments") / W
            gm, gsq = mom[0], mom[1]
            adv_n = (adv - gm) / (torch.sqrt(torch.clamp(gsq - gm * gm,
                                                         min=0.0)) + 1e-8)
        pg1 = ratio * adv_n
        pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
        pg_loss = -torch.minimum(pg1, pg2).mean()
        v_loss = 0.5 * torch.square(value - target).mean()
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=1).mean()
        total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
        if bc_data is not None and cfg.bc_coef > 0:
            dev = obs.device
            bc_logits, _ = model(torch.as_tensor(bc_data[0], dtype=torch.float32,
                                                 device=dev))
            bc_act = torch.as_tensor(bc_data[1], dtype=torch.int64, device=dev)
            bc_ce = -F.log_softmax(bc_logits, dim=-1).gather(
                1, bc_act[:, None]).mean()
            total = total + cfg.bc_coef * bc_ce
        return total, (pg_loss, v_loss, entropy)

    def update(ts: TrainState, batch, perms, generator=None):
        if generator is not None:
            raise ValueError("update takes its permutations from ngx's keys "
                             "(epoch_perms); the generator form was removed")
        obs, action, logp, adv, target = batch
        N = obs.shape[0]
        mb = N // cfg.num_minibatches
        params = list(ts.model.parameters())
        aux = []
        for e in range(cfg.epochs):
            perm = perms[e]
            if not isinstance(perm, torch.Tensor):
                perm = torch.as_tensor(np.asarray(perm, np.int64))
            idxs = perm.to(obs.device, torch.int64)[
                :mb * cfg.num_minibatches].reshape(cfg.num_minibatches, mb)
            for idx in idxs:
                ts.opt.zero_grad(set_to_none=True)
                total, terms = loss_fn(ts.model, obs[idx], action[idx],
                                       logp[idx], adv[idx], target[idx])
                total.backward()
                if mesh is not None:
                    grads = [p.grad for p in params]
                    flat = mesh.all_reduce(torch.cat(
                        [g.reshape(-1) for g in grads]), "grad") / W
                    for g, avg in zip(grads, flat.split(
                            [g.numel() for g in grads])):
                        g.copy_(avg.view_as(g))
                clip_by_global_norm(params, cfg.max_grad_norm)
                ts.opt.step()
                aux.append(torch.stack([x.detach() for x in terms]))
        aux = torch.stack(aux).reshape(cfg.epochs, cfg.num_minibatches, 3)
        if mesh is not None:
            aux = mesh.all_reduce(aux, "aux") / W
        return aux[..., 0], aux[..., 1], aux[..., 2]

    return gae, update


def make_learner(cfg: PPOConfig, spec, bc_data=None, mesh=None):
    """The learning half of a train step, shared by :func:`make_train` and
    the chain trainer (:mod:`ngx_torch.rl.curriculum`):
    ``learn(ts, (obs_t, action, reward, done), last_obs, ep_ret, pre_count,
    phase, perms) -> (ep_ret, metrics)``.

    It recomputes logp and the value over the emitted obs in one batched
    pass (the update's recompute path, so ratio == 1 at the first
    minibatch), applies the solve-shaped reward, runs GAE, folds the
    rewards into each env's running return and emits the completed
    episodes' tallies (the Monitor analog; ``pre_count`` is each env's
    steps into its episode before the rollout), then updates ``ts``.
    ``phase`` is the step's :class:`~ngx_torch.utils.trace.Phases`, in
    which it opens ``ngx_torch.train.recompute``, ``.gae`` and ``.update``
    (which ends with the step); ``perms`` go to ``update``.  Under a ``mesh`` the update is :func:`make_ppo_core`'s
    shard-local one and the metrics are made global by one all-reduce: the
    means averaged over the equal shards, the sums and counts summed."""
    gae, update = make_ppo_core(cfg, bc_data=bc_data, mesh=mesh)

    def learn(ts, rollout, last_obs, ep_ret, pre_count, phase, perms):
        phase("ngx_torch.train.recompute")
        obs_t, action, reward, done = rollout
        T, B = action.shape
        with torch.no_grad():
            logits, value = ts.model(obs_t)
            logp = F.log_softmax(logits, dim=-1).gather(
                -1, action.long()[..., None])[..., 0]
            if cfg.solve_shaped:
                solved_step = done & (reward > 0.5 * spec.reward_done)
                reward = torch.where(
                    solved_step, torch.full_like(reward, spec.reward_done),
                    torch.full_like(reward, -1.0))
            _, last_value = ts.model(last_obs)
            phase("ngx_torch.train.gae")
            adv, target = gae(value, reward, done, last_value)
            run, run_len = ep_ret, pre_count.to(torch.int64)
            dev = reward.device
            ep_total = torch.zeros((), device=dev)
            ep_count = torch.zeros((), dtype=torch.int64, device=dev)
            ep_solved = torch.zeros((), dtype=torch.int64, device=dev)
            ep_len = torch.zeros((), dtype=torch.int64, device=dev)
            for t in range(T):
                r, d = reward[t], done[t]
                run = run + r
                run_len = run_len + 1
                ep_total = ep_total + torch.where(d, run, 0.0).sum()
                ep_count = ep_count + d.sum()
                ep_solved = ep_solved + (d & (r > 0.5 * spec.reward_done)).sum()
                ep_len = ep_len + torch.where(d, run_len, 0).sum()
                run = torch.where(d, 0.0, run)
                run_len = torch.where(d, 0, run_len)
        phase("ngx_torch.train.update")
        flat = (obs_t.reshape(T * B, -1), action.reshape(-1),
                logp.reshape(-1), adv.reshape(-1), target.reshape(-1))
        pg, vl, ent = update(ts, flat, perms=perms)
        mean_reward, episodes = reward.mean(), done.sum()
        if mesh is not None:
            with torch.no_grad():
                tot = mesh.all_reduce(torch.stack(
                    [x.to(torch.float64) for x in (
                        mean_reward, episodes, ep_total, ep_count, ep_solved,
                        ep_len)]), "metrics")
            mean_reward = (tot[0] / mesh.size).to(torch.float32)
            ep_total = tot[2].to(torch.float32)
            episodes, ep_count, ep_solved, ep_len = (
                tot[i].to(torch.int64) for i in (1, 3, 4, 5))
        return run, {
            "mean_reward": mean_reward,
            "episodes": episodes,
            "ep_return_sum": ep_total,
            "ep_count": ep_count,
            "ep_solved": ep_solved,
            "ep_len_sum": ep_len,
            "pg_loss": pg.mean(),
            "v_loss": vl.mean(),
            "entropy": ent.mean(),
        }

    return learn


def keys_only(rng: str):
    """Refuse any ``rng`` but ``'threefry'``: the host layer draws from
    ngx's keys only.  The keyword stays on :func:`make_train`,
    :func:`~ngx_torch.rl.curriculum.make_train_chain` and
    :func:`~ngx_torch.rl.evaluate.make_eval` because ``portbench/runners``
    pass it."""
    if rng != "threefry":
        raise ValueError(f"rng {rng!r}: the host layer draws from ngx's keys "
                         "only ('threefry'); the counter form was removed")


def make_train(cfg: PPOConfig, mesh=None, spec_override=None,
               rollout_backend: str = "auto", bc_data=None, device="cuda",
               rng: str = "threefry"):
    """Returns ``(init_fn, train_step_fn)``: ngx's ``make_train`` on ngx's
    keys (a key is an int64 ``[2]`` tensor of :mod:`ngx_torch.ops.threefry`,
    or an int for ``key(int)``; held on the host, where the scalar seeds are
    derived with no device read).  ``rng`` accepts ``'threefry'`` only
    (:func:`keys_only`).

    ``init_fn(key) -> (train_state, env_state, obs, ep_returns)``: ``k_env,
    k_net = split(key)``; the env state is ngx's native reset over
    ``split(k_env, B)`` (on ``device``), the parameters
    :meth:`ActorCritic.from_key` of ``k_net`` (drawn on the host, so every
    device gets the same).  ``train_step_fn(carry, key) -> (carry,
    metrics)``, one rollout and update cycle: ``k_roll, k_upd =
    split(key)``; the kernel's seed is ``randint(k_roll, (), 0, 2^31 -
    1)``, or in pool mode ``k_seed, k_pool = split(k_roll)`` gives the
    kernel's seed and the pool's (``train.py:391-412``); ``'xla'`` acts by
    :func:`rollout_keyed` on ``k_roll``; the update's permutations are
    :func:`epoch_perms` of ``k_upd`` (``fold_in(k_upd, rank)`` under a
    mesh).  From ``key(0)`` this is ngx's ``make_train(cfg)`` run from
    ``jax.random.key(0)``: start states, seeds and permutations bit for
    bit, the parameters up to float rounding.  ``train_step_fn.seeds``
    holds the last step's ``(kernel seed, pool seed)`` (None where not
    drawn) and ``train_step_fn.perms`` its permutations.

    The carry's tensors live on ``device``: the card by default (it raises
    where there is none), where the acting kernel runs; ``"cpu"`` runs its
    plain twin.  ``spec_override`` trains on a custom spec instead of the
    preset, a novelty-injected one for instance, with any number of item
    ids and the NOOP op (it must pass
    :func:`~ngx_torch.core.spec.check_kernel_supported` on the card's
    kernel — whose one limit is the card's shared memory, asked of the
    library here — and
    :func:`~ngx_torch.core.spec.check_supported` on ``'xla'``: ``'auto'``
    on a spec past the kernels' limit raises, never taking ``'xla'`` by
    itself).  ``train_step_fn.reset_source`` is the mode the kernel runs
    in (:func:`reset_source`).  A step is tiled by its phases, the spans
    ``ngx_torch.train.pool`` (pool mode), ``.acting``, ``.permutation``,
    ``.recompute``, ``.gae`` and ``.update``, with every
    keyed draw in a nested ``ngx_torch.train.draw`` and the pool's draw in
    a nested ``ngx_torch.train.pool_draw`` (counts ``rows``, the pool rows
    this rank keeps, and ``edits``, the spec's reset edits); they are recorded
    inside a ``torch.profiler`` session (:mod:`ngx_torch.utils.trace`).
    Setting ``train_step_fn.phases`` to a dict times each step by phase:
    the host-clock seconds of each, ended by a device synchronize,
    appended under its last name (the synchronizes cost a little; None,
    the default, times nothing).  With ``train_step_fn.keep_rollout`` set,
    each step leaves its ``(obs_t, action, reward, done)`` in
    ``train_step_fn.rollout``.

    ``rollout_backend``: ``'auto'`` and ``'pallas'`` run the acting
    kernel; ``'xla'`` runs the unfused loop (ngx's XLA backend),
    :func:`rollout_keyed`.  Under reset edits it follows ngx's XLA path,
    not the pool: every boundary draws a keyed reset with the spec's edits
    (:meth:`KeyedVecEnv.step_rows`), so no pool is drawn and
    ``reset_source`` is ``'vec'``.  ``train_step_fn.rollout_backend``
    names the backend taken, ``'pallas'`` or ``'xla'``.

    ``mesh`` (:func:`ngx_torch.parallel.make_env_mesh`): this rank's part
    of ngx's sharded trainer, on the mesh's device.  The rank holds the
    global rows ``[k*B/W, (k+1)*B/W)`` of the init's reset (its rows of
    ``split(k_env, B)``); its acting seed is ``seed + rank*612331`` wrapped
    to int32 (:func:`~ngx_torch.parallel.shard_seed`); in pool mode every
    rank draws the global pool of ``B*R`` resets and restores from its rows
    ``[k*B/W*R, (k+1)*B/W*R)``; its permutations come from ``fold_in(k_upd,
    rank)``; the update is shard-local and the metrics global
    (:func:`make_learner`).  The parameters are the same on every rank,
    and ``init`` checks them against rank 0's by a broadcast.  ``'auto'``
    runs the acting kernel on each rank's shard, as it does unsharded
    (ngx's ``auto`` takes its unfused loop under a mesh,
    ``train.py:256-262``, because its Pallas kernel is picked on a single
    TPU only; the CUDA kernel has no such limit); the 128-env gate is on
    the per-rank batch ``B // W``."""
    from ..parallel import EnvMesh, host_local_keys, shard_seed

    backend = acting_backend(rollout_backend)
    keys_only(rng)
    if mesh is not None and not isinstance(mesh, EnvMesh):
        raise TypeError(f"mesh {mesh!r} is not an EnvMesh "
                        "(ngx_torch.parallel.make_env_mesh)")
    spec = spec_override or make_spec(cfg.env_id)
    if spec.obs_mode != S.OBS_LIDAR_FRONT:
        spec = lidar_in_front(spec)
    S.check_supported(spec)
    W = 1 if mesh is None else mesh.size
    B, T = cfg.num_envs, cfg.rollout_steps
    if B % W or (B // W) % 128 != 0:
        # the same gate as ngx (train.py:253-255): the acting kernel's RNG
        # streams come in blocks of 128 envs of a device's shard
        raise ValueError(f"per-device batch {B // W} ({B} envs over {W} "
                         "device(s)) is not a multiple of the 128-env block")
    device = mesh.device if mesh is not None else resolve_device(device)
    if backend == "pallas" and device.type == "cuda":
        from ..ops._build import load_library
        S.check_kernel_supported(
            spec, [lidar_obs_dim(spec), *cfg.hidden, spec.n_actions],
            load_library())
    B_loc = B // W
    rank = 0 if mesh is None else mesh.rank
    block = pick_trainer_block(B_loc)
    source = reset_source(spec) if backend == "pallas" else "vec"
    get_obs = make_step(spec, with_obs=False).get_obs
    learn = make_learner(cfg, spec, bc_data=bc_data, mesh=mesh)
    vec = KeyedVecEnv(spec, episode_cap=cfg.episode_cap, reset_obs=True)

    def init(key):
        k_env, k_net = TF.split(TF.as_key(key))
        keys = (TF.split(k_env.to(device), B) if mesh is None
                else host_local_keys(k_env, B, mesh))
        env_state, obs = vec.reset(keys)
        obs = obs.to(torch.float32)
        model = ActorCritic.from_key(k_net, obs.shape[1], spec.n_actions,
                                     cfg.hidden).to(device)
        if mesh is not None:
            own = torch.cat([p.detach().reshape(-1)
                             for p in model.parameters()])
            if not torch.equal(mesh.broadcast(own.clone(), "params-check"),
                               own):
                raise RuntimeError(f"rank {rank}'s initial parameters "
                                   "differ from rank 0's")
        opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, eps=1e-5)
        ep_ret = torch.zeros((B_loc,), dtype=torch.float32, device=device)
        return TrainState(model, opt), env_state, obs, ep_ret

    def draw_pool(pool_seed: int):
        """A fresh pool of B*R resets for this launch, env b's slot r at
        row b*R + r (train.py:395-407); under a mesh the whole pool is
        drawn and the rank keeps its envs' rows."""
        with trace.span("ngx_torch.train.pool_draw") as span:
            pool = pool_reset(spec, B * POOL_SLOTS, pool_seed, device)
            if mesh is not None:
                pool = pool.take(slice(rank * B_loc * POOL_SLOTS,
                                       (rank + 1) * B_loc * POOL_SLOTS))
            span.count("rows", B_loc * POOL_SLOTS)
            span.count("edits", len(spec.reset_edits))
        return pool, torch.zeros((B_loc,), dtype=torch.int32, device=device)

    def act_kernel(ts, env_state, roll_seed: int, pool, base):
        seed_k = roll_seed if mesh is None else shard_seed(roll_seed, rank)
        pi_layers = [(w.detach(), b.detach())
                     for w, b in ts.model.pi_layers()]
        env_state, obs_t, action, reward, done = train_rollout(
            spec, env_state, pi_layers, seed_k, T, block=block,
            cap=cfg.episode_cap, pool=pool, base=base)[:5]
        return (env_state, obs_t, action, reward, done,
                get_obs(env_state).to(torch.float32))

    # the step's first phase: the pool's draw where there is one
    first = "ngx_torch.train.pool" if source == "pool" else \
        "ngx_torch.train.acting"

    def train_step(carry, key):
        with trace.Phases(step.phases, device) as phase:
            phase(first)
            ts, env_state, obs, ep_ret = carry
            with trace.span("ngx_torch.train.draw"):
                k_roll, k_upd = TF.split(TF.as_key(key))
            roll_seed = pool_seed = pool = base = None
            if backend == "pallas":
                k_seed = k_roll
                if source == "pool":
                    with trace.span("ngx_torch.train.draw"):
                        k_seed, k_pool = TF.split(k_roll)
                        pool_seed = draw_seed(k_pool)
                    pool, base = draw_pool(pool_seed)
                    phase("ngx_torch.train.acting")
                with trace.span("ngx_torch.train.draw"):
                    roll_seed = draw_seed(k_seed)
            step.seeds = (roll_seed, pool_seed)
            # steps already taken in each env's current episode BEFORE this
            # rollout — seeds the episode-length tally
            pre_count = env_state.step_count
            if backend == "xla":
                acted = rollout_keyed(ts.model, vec, env_state, obs, k_roll,
                                      T, B, rank * B_loc)
            else:
                acted = act_kernel(ts, env_state, roll_seed, pool, base)
            phase("ngx_torch.train.permutation")
            with trace.span("ngx_torch.train.draw"):
                step.perms = epoch_perms(cfg, k_upd if mesh is None
                                         else TF.fold_in(k_upd, rank),
                                         T * B_loc, device)
            env_state, obs_t, action, reward, done, last_obs = acted
            if step.keep_rollout:
                step.rollout = (obs_t, action, reward, done)
            run, metrics = learn(ts, (obs_t, action, reward, done), last_obs,
                                 ep_ret, pre_count, phase, step.perms)
            return (ts, env_state, last_obs, run), metrics

    step = train_step
    step.reset_source = source
    step.rollout_backend = backend
    step.phases = None
    step.keep_rollout = False
    step.rollout = None
    step.seeds = step.perms = None
    return init, step


def train(cfg: PPOConfig, num_updates: int, seed=0, mesh=None,
          log_every: int = 10, rollout_backend: str = "auto", device="cuda"):
    """Host loop: init once, then ``num_updates`` train steps through
    ``rollout_backend`` (as ngx's ``train``, ``train.py:533-548``), over
    ``mesh`` when given (every rank runs it; rank 0 prints the global
    metrics).  ``seed`` is a key, or an int for ``key(int)``: the init
    takes the key and update ``u`` ``fold_in(key, u + 1)``, as ngx's."""
    init, train_step = make_train(cfg, mesh, rollout_backend=rollout_backend,
                                  device=device)
    key = TF.as_key(seed)
    carry = init(key)
    history = []
    for u in range(num_updates):
        carry, metrics = train_step(carry, TF.fold_in(key, u + 1))
        if (u + 1) % log_every == 0 or u == num_updates - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append(m)
            if mesh is None or mesh.rank == 0:
                print(f"update {u+1}: " + " ".join(
                    f"{k}={v:.3f}" for k, v in m.items()))
    return carry, history


def _dryrun_rank(mesh):
    """One rank of :func:`dryrun`: one step through each acting backend at
    128 envs a rank, from ``key(0)`` and the step on ``key(1)``; returns
    each backend's global metrics."""
    out = {}
    for backend in ("xla", "pallas"):
        cfg = PPOConfig(num_envs=128 * mesh.size, rollout_steps=4,
                        num_minibatches=2, epochs=1, hidden=(16, 16))
        init, train_step = make_train(cfg, mesh, rollout_backend=backend)
        carry = init(TF.key(0))
        if carry[1].batch != 128 or carry[1].device != mesh.device:
            raise RuntimeError(f"rank {mesh.rank} holds {carry[1].batch} "
                               f"envs on {carry[1].device}, not its shard")
        carry, metrics = train_step(carry, TF.key(1))
        out[backend] = {k: float(v) for k, v in metrics.items()}
    return out


def dryrun(n_devices: int, device="cuda", backend=None,
           timeout: float = 600.0) -> dict:
    """The multi-device dry run, ngx's ``dryrun`` (``train.py:551-580``):
    ``n_devices`` ranks, each on its own process — NCCL on the cards by
    default, one rank a card (``backend='gloo'`` for more ranks than
    cards), gloo with ``device="cpu"`` — run one sharded train
    step through each acting backend ('xla', the unfused loop, and
    'pallas', the kernel on the card and its twin on the CPU) at 128 envs a
    rank.  Every rank must report the same global metrics, all finite.
    Returns rank 0's."""
    from ..parallel import spawn_ranks

    results = spawn_ranks(_dryrun_rank, n_devices, device=device,
                          backend=backend, timeout=timeout)
    for r, res in enumerate(results):
        if res != results[0]:
            raise RuntimeError(f"rank {r}'s global metrics differ from "
                               f"rank 0's: {res} != {results[0]}")
        for backend_name, m in res.items():
            if not all(np.isfinite(v) for v in m.values()):
                raise RuntimeError(f"{backend_name}: metrics not finite: {m}")
    return results[0]
