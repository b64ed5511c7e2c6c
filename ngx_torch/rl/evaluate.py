"""Batched policy evaluation — the port of ``ngx/rl/evaluate.py``:
``make_eval`` (``:27``), ``evaluate_checkpoint`` (``:101``),
``evaluate_expert`` (``:123``) and ``evaluate_sb2_zip`` (``:168``).

B independent episodes step together, each for at most ``cap`` steps, with
first-done bookkeeping: an episode's return, length and solve are counted
until its first done and never after.  The loop is plain torch on the
device (the card by default): the fused 'policy' rollout kernel
auto-resets where evaluation must stop counting, so it does not serve here.

An episode is "solved" when it ends with a terminal reward above
``reward_done / 2``: the goal step pays ``reward_done`` (+50) on every env,
while other terminations pay at most +10 or less than zero (ngx's note,
``evaluate.py:8-14``).

The draws are ngx's keys (:mod:`ngx_torch.ops.threefry`): ``run(params,
key, episodes)`` is ngx's, ``k0, k1 = split(key)``, the start states
ngx's native reset over ``split(k0, episodes)``, and at step ``t`` of
``split(k1, cap)`` the actions ``randint`` or ``categorical`` on ``k_act``
and the done envs' resets on ``split(k_reset, episodes)``
(:class:`~ngx_torch.vector.KeyedVecEnv`): the random baseline's metrics
equal ngx's, and a policy's too up to a Gumbel near-tie between its logits
and flax's (they differ by float rounding).  :func:`evaluate_expert` draws
nothing of its own: it runs the scripted expert through the single-env
facade's mirror reset, so its metrics equal ngx's exactly.
"""

from __future__ import annotations

import re

import torch

from ..core import spec as S
from ..ops import threefry as TF
from ..ops.tables import resolve_device
from ..presets import make_spec
from ..transforms import lidar_in_front
from ..utils import trace
from ..vector import KeyedVecEnv
from .models import ActorCritic
from .train import keys_only


def as_policy(params, device):
    """``params`` as an :class:`ActorCritic` on ``device``: a module as it
    is, a state dict loaded into a new ``ActorCritic`` whose obs dim,
    widths and action count are read from the weights' shapes; None stays
    None (uniform random actions)."""
    if params is None:
        return None
    if not isinstance(params, ActorCritic):
        n_hidden = sum(1 for k in params
                       if re.fullmatch(r"pi_\d+\.weight", k))
        model = ActorCritic(
            params["pi_0.weight"].shape[1], params["pi_out.weight"].shape[0],
            [params[f"pi_{i}.weight"].shape[0] for i in range(n_hidden)])
        model.load_state_dict(params)
        params = model
    return params.to(device)


def play_first_done(step, act, state, obs, cap: int, reward_done: float,
                    hold: bool = False) -> dict:
    """Up to ``cap`` steps of ``step(state, actions, t) -> (state, obs,
    reward, done)`` under ``act(t, obs) -> actions``, with first-done
    bookkeeping: an env's return, length and solve (a terminal reward above
    ``reward_done / 2``) count until its first done and never after, and
    the loop ends once every env has had one.  ``hold`` keeps each env's
    state and obs from the step before its first done (no auto-reset).
    Returns ``mean_return``, ``solve_rate``, ``done_rate`` and
    ``mean_length`` (floats).  The span ``ngx_torch.eval.run`` counts the
    ``steps`` and the ``host_reads`` (each ``bool`` or ``float`` of a
    device tensor: one a step and the four metrics)."""
    n, device = obs.shape[0], obs.device
    ret = torch.zeros((n,), dtype=torch.float32, device=device)
    length = torch.zeros((n,), dtype=torch.int32, device=device)
    done_ever = torch.zeros((n,), dtype=torch.bool, device=device)
    solved = torch.zeros_like(done_ever)
    with trace.span("ngx_torch.eval.run") as run:
        played = 0
        for t in range(cap):
            played += 1
            new, new_obs, r, done = step(state, act(t, obs), t)
            active = ~done_ever
            ret = ret + torch.where(active, r, 0.0)
            length = length + active.to(torch.int32)
            solved = solved | (active & done & (r > 0.5 * reward_done))
            done_ever = done_ever | done
            if hold:
                new = state.where(done_ever, new)
                new_obs = torch.where(done_ever[:, None], obs, new_obs)
            state, obs = new, new_obs
            if bool(done_ever.all()):
                break    # nothing counts after every first done
        out = {"mean_return": float(ret.mean()),
               "solve_rate": float(solved.to(torch.float32).mean()),
               "done_rate": float(done_ever.to(torch.float32).mean()),
               "mean_length": float(length.to(torch.float32).mean())}
        run.count("steps", played)
        run.count("host_reads", played + len(out))
    return out


def make_eval(spec, cap: int = 100, apply_logits=None,
              wrap_lidar: bool = True, device="cuda", rng: str = "threefry"):
    """Build ``run(params, key, episodes) -> metrics`` for ``spec`` (``key``
    a key tensor, or an int for ``key(int)``): ``mean_return``,
    ``solve_rate``, ``done_rate`` and ``mean_length`` (floats) over
    ``episodes`` episodes of at most ``cap`` steps (the loop length; there
    is no cap inside the vector env).  ``rng`` accepts ``'threefry'`` only
    (:func:`~ngx_torch.rl.train.keys_only`).

    ``params``: an :class:`ActorCritic`, its state dict (any widths), or
    None for the uniform-random baseline.
    ``apply_logits(params, obs_f32) -> logits`` swaps in another forward
    pass, as in ngx.  Observations are LidarInFront over the base spec;
    ``wrap_lidar=False`` keeps the spec's own.  ``device`` defaults to the
    card and raises where there is none.

    Its spans (:mod:`ngx_torch.utils.trace`, recorded inside a
    ``torch.profiler`` session): ``ngx_torch.eval.policy`` (a state dict
    made an ``ActorCritic``), ``ngx_torch.eval.reset`` (the start reset and
    each step's reset of the done rows, counting the ``envs`` and the
    ``kernel_envs`` that the reset kernel reset) and ``ngx_torch.eval.run``
    (:func:`play_first_done`)."""
    if wrap_lidar and spec.obs_mode != S.OBS_LIDAR_FRONT:
        spec = lidar_in_front(spec)
    keys_only(rng)
    device = resolve_device(device)
    vec = KeyedVecEnv(spec)
    n_actions = spec.n_actions

    def policy(params):
        if params is None:
            return None
        if apply_logits is None:
            with trace.span("ngx_torch.eval.policy"):
                model = as_policy(params, device)
            return lambda o: model(o)[0]
        return lambda o: apply_logits(params, o)

    def run(params, key, episodes: int):
        logits_fn = policy(params)
        k0, k1 = TF.split(TF.as_key(key, device))
        with trace.span("ngx_torch.eval.reset") as reset:
            state, obs = vec.reset(TF.split(k0, episodes))
            reset.count("envs", episodes)
            reset.count("kernel_envs",
                        episodes if device.type == "cuda" else 0)
        keys = TF.split(TF.split(k1, cap), 2)     # [cap, 2 (act, reset), 2]

        def act(t, obs):
            if logits_fn is None:
                return TF.randint(keys[t, 0], (episodes,), 0, n_actions)
            with torch.no_grad():
                return TF.categorical(keys[t, 0],
                                      logits_fn(obs.to(torch.float32)))

        def step(state, a, t):
            state, obs, r, done, _ = vec.step_rows(state, a, keys[t, 1])
            return state, obs, r, done

        return play_first_done(step, act, state, obs, cap, spec.reward_done)

    return run


def evaluate_checkpoint(env_id: str, ckpt_path: str, episodes: int = 128,
                        cap: int = 100, seed: int = 0,
                        include_random: bool = True, device="cuda"):
    """Evaluate a saved agent (a :mod:`ngx_torch.utils.checkpoint` file;
    its widths read from its weights, where ngx reads its config's
    ``hidden``, ``evaluate.py:114``) and, by default, the random baseline on
    ``env_id``.  Returns ``{'trained': {...}[, 'random': {...}]}`` metric
    dicts: the agent runs on ``key(seed)`` and the random baseline on
    ``fold_in(key(seed), 1)``, as ngx's."""
    from ..utils.checkpoint import restore_checkpoint

    run = make_eval(make_spec(env_id), cap=cap, device=device)
    key = TF.key(seed)
    out = {"trained": run(restore_checkpoint(ckpt_path)["params"], key,
                          episodes)}
    if include_random:
        out["random"] = run(None, TF.fold_in(key, 1), episodes)
    return out


def evaluate_expert(env_id: str, episodes: int = 128, cap: int = 100,
                    seed: int = 0, device="cuda"):
    """Evaluate the scripted expert (:mod:`ngx_torch.rl.experts`) under the
    batched evaluator's protocol: ``episodes`` episodes, a ``cap``-step cap,
    solved = goal termination before the cap (a terminal reward above
    ``reward_done / 2``).

    The experts are host-side state machines (BFS over the live map), so
    this runs through the single-env facade one env at a time, on
    ``device`` (the card by default; it raises where there is none).  Episode
    ``ep`` starts from ``np.random.seed(seed * 100_000 + ep)`` and the mirror
    reset, ngx's schedule, so the dict equals ngx's exactly.  The solve and
    return ceiling for the eval table, not a throughput path."""
    import numpy as np

    from .. import compat as C
    from .experts import get_expert

    env = C.make(env_id, device=device)
    expert = get_expert(env_id)
    ret = np.zeros(episodes)
    length = np.zeros(episodes, np.int32)
    done_ever = np.zeros(episodes, bool)
    solved = np.zeros(episodes, bool)
    for ep in range(episodes):
        np.random.seed(seed * 100_000 + ep)
        env.reset()
        total, done, r = 0.0, False, 0.0
        t = 0
        for t in range(cap):
            _, r, done, _ = env.step(expert(env))
            total += r
            if done:
                break
        ret[ep] = total
        length[ep] = t + 1
        done_ever[ep] = done
        # goal-termination test (see make_eval's threshold note): v2's
        # dead-end done can follow a +10 craft
        solved[ep] = done and r > 0.5 * env.reward_done
    return {
        "mean_return": float(ret.mean()),
        "solve_rate": float(solved.mean()),
        "done_rate": float(done_ever.mean()),
        "mean_length": float(length.mean()),
    }


def evaluate_sb2_zip(env_id: str, zip_path: str, episodes: int = 128,
                     cap: int = 100, seed: int = 0, device="cuda"):
    """Run one of the reference's SB2 checkpoints (:mod:`ngx_torch.rl.sb2`)
    through :func:`make_eval` on the env's own observation (the legacy
    envs' lidar arrays, what SB2 trained on), with the reference's protocol
    (reference ``enjoy.py:49-72,87``: stochastic actions, a Gumbel draw on
    ``key(seed)``, as ngx's).  Returns one metrics dict.  ``device``
    defaults to the card and raises where there is none."""
    from ..core.reset import make_reset
    from .sb2 import check_dims, load_sb2_params, sb2_apply, sb2_to_device

    device = resolve_device(device)
    spec = make_spec(env_id)
    params = sb2_to_device(load_sb2_params(zip_path), device)
    _, obs0 = make_reset(spec, device)(TF.key(0)[None])     # as ngx's
    check_dims(params, int(obs0.shape[-1]), spec.n_actions, zip_path)
    run = make_eval(spec, cap=cap, wrap_lidar=False, device=device,
                    apply_logits=lambda p, obs: sb2_apply(p, obs)[0])
    return run(params, seed, episodes)
