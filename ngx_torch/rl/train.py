"""PPO training — the port of ``ngx/rl/train.py`` (``PPOConfig``, ``make_ppo_core``,
``make_train``, ``train``).

Algorithmic surface as in the JAX package (SB2 PPO2 defaults, reference
``tests/train.py:122,135``: clipped surrogate, GAE, minibatch epochs).  The
acting loop is :func:`ngx_torch.ops.train_rollout.train_rollout`: the CUDA
kernel for a CUDA device, its plain twin on the CPU — the device decides, and
there is no second backend.  ``logp`` and the value are recomputed over the
emitted obs outside the kernel, as ``train.py:418-421`` does.  A spec whose
reset has edits (the novelty percent-fills, the v3 wall coin, the
Pogostick-v0 tap) takes the kernel's pool-reset mode, as ngx's trainer does
(``train.py:330-346``): each step draws a fresh pool of ``B * POOL_SLOTS``
counter resets (:func:`ngx_torch.ops.rollout.pool_reset`, the rollout kernel
at T 0 on the card) and a boundary restores the env's next slot.

Parity hazards with ``ngx``:

* ``adv.std()`` in JAX is the population std; torch's is unbiased by
  default, so the loss uses ``unbiased=False``;
* ``optax.clip_by_global_norm`` scales by ``max_norm / ||g||`` with no
  epsilon, unlike ``torch.nn.utils.clip_grad_norm_``: the clip is written
  out in :func:`clip_by_global_norm`;
* ``jax.random.permutation`` cannot be reproduced: ``update`` takes the
  epochs' permutations as an optional argument.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import spec as S
from ..core.reset import counter_reset
from ..core.step import make_step
from ..ops.rollout import pool_reset
from ..ops.tables import resolve_device
from ..ops.train_rollout import train_rollout
from ..presets import make_spec
from ..transforms import lidar_in_front
from .models import ActorCritic

_SEED_HI = 2 ** 31 - 1   # seeds drawn in [0, int32 max), as jax.random.randint
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


def clip_by_global_norm(params, max_norm: float):
    """``optax.clip_by_global_norm``: where ``||g|| >= max_norm`` every
    gradient becomes ``(g / ||g||) * max_norm`` — no epsilon."""
    grads = [p.grad for p in params if p.grad is not None]
    g_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    trigger = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(trigger, g, (g / g_norm) * max_norm))


def make_ppo_core(cfg: PPOConfig, bc_data=None):
    """The PPO math, independent of how the rollout is produced:
    ``gae(values, rewards, dones, last_value) -> (adv, target)`` and
    ``update(ts, (obs, action, logp, adv, target), perms=None,
    generator=None) -> (pg_loss, v_loss, entropy)`` each ``[epochs,
    num_minibatches]``.  ``perms``: one index permutation of the ``N``
    samples per epoch; when None they are drawn from ``generator``."""

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
        adv_n = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
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

    def draw_perm(N, generator):
        if cfg.shuffle == "affine":
            if N & (N - 1):
                raise ValueError(
                    "affine shuffle needs power-of-two num_envs*rollout")
            a = int(torch.randint(0, N // 2, (), generator=generator)) * 2 + 1
            r = int(torch.randint(0, N, (), generator=generator))
            return (torch.arange(N) * a + r) % N
        return torch.randperm(N, generator=generator)

    def update(ts: TrainState, batch, perms=None, generator=None):
        obs, action, logp, adv, target = batch
        N = obs.shape[0]
        mb = N // cfg.num_minibatches
        params = list(ts.model.parameters())
        aux = []
        for e in range(cfg.epochs):
            perm = perms[e] if perms is not None else draw_perm(N, generator)
            idxs = torch.as_tensor(np.asarray(perm, np.int64),
                                   device=obs.device)[
                :mb * cfg.num_minibatches].reshape(cfg.num_minibatches, mb)
            for idx in idxs:
                ts.opt.zero_grad(set_to_none=True)
                total, terms = loss_fn(ts.model, obs[idx], action[idx],
                                       logp[idx], adv[idx], target[idx])
                total.backward()
                clip_by_global_norm(params, cfg.max_grad_norm)
                ts.opt.step()
                aux.append(torch.stack([x.detach() for x in terms]))
        aux = torch.stack(aux).reshape(cfg.epochs, cfg.num_minibatches, 3)
        return aux[..., 0], aux[..., 1], aux[..., 2]

    return gae, update


class PhaseTimer:
    """Times a train step by phase.  ``mark(name)`` ends the phase
    ``name``: it appends the host-clock seconds since the previous mark,
    after a device synchronize, to ``phases[name]``; ``mark(None)`` starts
    the clock.  With ``phases`` None it times nothing (the synchronizes
    cost a little)."""

    def __init__(self, phases, device):
        self.phases, self.device = phases, device
        self.t = 0.0
        self(None)

    def __call__(self, name):
        if self.phases is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if name is not None:
            self.phases.setdefault(name, []).append(now - self.t)
        self.t = now


def make_learner(cfg: PPOConfig, spec, bc_data=None):
    """The learning half of a train step, shared by :func:`make_train` and
    the chain trainer (:mod:`ngx_torch.rl.curriculum`):
    ``learn(ts, (obs_t, action, reward, done), last_obs, ep_ret, pre_count,
    mark, generator=None, perms=None) -> (ep_ret, metrics)``.

    It recomputes logp and the value over the emitted obs in one batched
    pass (the update's recompute path, so ratio == 1 at the first
    minibatch), applies the solve-shaped reward, runs GAE, folds the
    rewards into each env's running return and emits the completed
    episodes' tallies (the Monitor analog; ``pre_count`` is each env's
    steps into its episode before the rollout), then updates ``ts``.
    ``mark`` is a :class:`PhaseTimer` (phases ``recompute``, ``gae``,
    ``update``); ``generator`` and ``perms`` go to ``update``."""
    gae, update = make_ppo_core(cfg, bc_data=bc_data)

    def learn(ts, rollout, last_obs, ep_ret, pre_count, mark, generator=None,
              perms=None):
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
            mark("recompute")
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
            mark("gae")
        flat = (obs_t.reshape(T * B, -1), action.reshape(-1),
                logp.reshape(-1), adv.reshape(-1), target.reshape(-1))
        pg, vl, ent = update(ts, flat, perms=perms, generator=generator)
        mark("update")
        return run, {
            "mean_reward": reward.mean(),
            "episodes": done.sum(),
            "ep_return_sum": ep_total,
            "ep_count": ep_count,
            "ep_solved": ep_solved,
            "ep_len_sum": ep_len,
            "pg_loss": pg.mean(),
            "v_loss": vl.mean(),
            "entropy": ent.mean(),
        }

    return learn


def make_train(cfg: PPOConfig, mesh=None, spec_override=None, bc_data=None,
               device="cuda"):
    """Returns ``(init_fn, train_step_fn)``.

    ``init_fn(seed) -> (train_state, env_state, obs, ep_returns)``;
    ``train_step_fn(carry, seed) -> (carry, metrics)`` — one rollout and
    update cycle.  The carry's tensors live on ``device``: the card by
    default (it raises where there is none), where the acting kernel runs;
    ``"cpu"`` runs its plain twin.  ``spec_override`` trains on a custom
    spec instead of the preset, a novelty-injected one for instance (it
    must pass :func:`~ngx_torch.core.spec.check_supported`).  Seeds are
    Python ints; each seeds a ``torch.Generator`` that draws, in this
    order, the step's rollout seed, in pool mode the pool's seed, then the
    minibatch permutations.  ``train_step_fn.reset_source`` is the mode
    the kernel runs in (:func:`reset_source`).  Setting
    ``train_step_fn.phases`` to a dict times each step by phase: the
    host-clock seconds of ``pool``, ``acting``, ``recompute``, ``gae`` and
    ``update``, each ended by a device synchronize, appended under its
    name (the synchronizes cost a little; None, the default, times
    nothing)."""
    if mesh is not None:
        raise NotImplementedError("sharding over a mesh is not ported to "
                                  "ngx_torch yet (ROADMAP.md, Queue 1)")
    spec = spec_override or make_spec(cfg.env_id)
    if spec.obs_mode != S.OBS_LIDAR_FRONT:
        spec = lidar_in_front(spec)
    S.check_supported(spec)
    B, T = cfg.num_envs, cfg.rollout_steps
    if B % 128 != 0:
        # the same gate as ngx (train.py:253): the acting kernel's RNG
        # streams come in blocks of 128 envs
        raise ValueError(f"per-device batch {B} is not a multiple of the "
                         "128-env block")
    device = resolve_device(device)
    block = pick_trainer_block(B)
    source = reset_source(spec)
    get_obs = make_step(spec, with_obs=False).get_obs
    learn = make_learner(cfg, spec, bc_data=bc_data)

    def init(seed: int):
        g = torch.Generator().manual_seed(int(seed))
        env_seed = int(torch.randint(0, _SEED_HI, (), generator=g))
        env_state = counter_reset(spec, env_seed, 0, B, device=device)
        obs = get_obs(env_state).to(torch.float32)
        model = ActorCritic(obs.shape[1], spec.n_actions, cfg.hidden,
                            generator=g).to(device)
        opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, eps=1e-5)
        ep_ret = torch.zeros((B,), dtype=torch.float32, device=device)
        return TrainState(model, opt), env_state, obs, ep_ret

    def train_step(carry, seed: int):
        mark = PhaseTimer(train_step.phases, device)
        ts, env_state, obs, ep_ret = carry
        g = torch.Generator().manual_seed(int(seed))
        roll_seed = int(torch.randint(0, _SEED_HI, (), generator=g))
        pool = base = None
        if source == "pool":
            # a fresh pool of B*R counter resets for this launch, env b's
            # slot r at row b*R + r (train.py:395-407)
            pool_seed = int(torch.randint(0, _SEED_HI, (), generator=g))
            pool = pool_reset(spec, B * POOL_SLOTS, pool_seed, device)
            base = torch.zeros((B,), dtype=torch.int32, device=device)
            mark("pool")
        # steps already taken in each env's current episode BEFORE this
        # rollout — seeds the episode-length tally
        pre_count = env_state.step_count
        pi_layers = [(w.detach(), b.detach()) for w, b in ts.model.pi_layers()]
        env_state, obs_t, action, reward, done = train_rollout(
            spec, env_state, pi_layers, roll_seed, T, block=block,
            cap=cfg.episode_cap, pool=pool, base=base)[:5]
        mark("acting")
        last_obs = get_obs(env_state).to(torch.float32)
        run, metrics = learn(ts, (obs_t, action, reward, done), last_obs,
                             ep_ret, pre_count, mark, generator=g)
        return (ts, env_state, last_obs, run), metrics

    train_step.reset_source = source
    train_step.phases = None
    return init, train_step


def train(cfg: PPOConfig, num_updates: int, seed: int = 0, log_every: int = 10,
          device="cuda"):
    """Host loop: init once, then ``num_updates`` train steps."""
    init, train_step = make_train(cfg, device=device)
    carry = init(seed)
    history = []
    for u in range(num_updates):
        carry, metrics = train_step(carry, seed * 1_000_003 + u + 1)
        if (u + 1) % log_every == 0 or u == num_updates - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append(m)
            print(f"update {u+1}: " + " ".join(
                f"{k}={v:.3f}" for k, v in m.items()))
    return carry, history
