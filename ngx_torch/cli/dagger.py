"""DAgger solver training: close the BC->expert solve gap — the port of
``ngx/cli/dagger.py``.

BC alone tops out below the scripted expert's solve ceiling because the
cloned policy drifts off the expert's state distribution and has no labels
there.  DAgger fixes exactly that: roll out the CURRENT policy, label every
visited state with the expert's action (:mod:`ngx_torch.rl.experts` — pure
functions of the live state, so they label arbitrary states), aggregate,
re-fit.

    python -m ngx_torch.cli.dagger -env NovelGridworld-Pogostick-v0 \\
        -rounds 8 -episodes_per_round 64 -ckpt agents/pogo_v0_solver

The rollout and labelling run the single-env facade (the experts are BFS
state machines over the live map); the refit is
:func:`ngx_torch.rl.bc.pretrain` and each round's evaluation is
:func:`ngx_torch.rl.evaluate.make_eval` at ``-eval_episodes``, all on
``-device`` (``cuda`` by default; ``-device cpu`` is ngx's default for this
driver).  Every draw is ngx's, from ngx's keys (:mod:`ngx_torch.ops.
threefry`; ``ngx/cli/dagger.py:53-72``, ``:130-174``): the model is
``ActorCritic.from_key(key(-seed))``, flax's init; round ``rnd`` fits on
``pretrain(key=key(seed + rnd))`` and evaluates each ``-sharpen`` factor on
``make_eval`` from ``key(seed*7 + rnd)``; a collection
draws its policy's actions from ``key(<its seed>)``, one split a policy
step, as ``ngx_torch.cli.enjoy`` does.  So from the same arguments the
rounds are ngx's: its frames and labels, its BC parameters up to float
rounding, its printed lines (up to a Gumbel near-tie between the port's
logits and flax's).  The best round by solve rate is saved to
``<ckpt>/best.pt`` (:mod:`ngx_torch.utils.checkpoint`, ngx's config keys),
which ``enjoy.load_policy`` reads.
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np
import torch

from .enjoy import DEVICE_HELP


def collect_policy_labeled(env_id: str, params, hidden, episodes: int,
                           cap: int, seed: int, mix_expert: float = 0.0,
                           device="cuda"):
    """Roll the current policy (stochastic, the eval protocol), label every
    visited state with the expert action.  Returns (obs[N,D], labels[N]).

    ``params=None`` rolls the expert itself (round 0 = plain BC data);
    otherwise an ``ActorCritic`` or its state dict (its widths read from
    the weights; ``hidden`` is kept for ngx's signature).
    ``mix_expert``: probability per step of EXECUTING the expert action
    instead of the policy's (beta-mixing, the original DAgger schedule),
    drawn from ``np.random.RandomState(seed)`` as ngx draws it.  The
    policy's actions are drawn from ``key(seed)``, ``key, k = split(key)``
    before each policy step, as ngx's.  ``device`` defaults to the card
    and raises where there is none."""
    from .. import compat as C
    from ..ops import threefry as TF
    from ..rl.experts import get_expert
    from .enjoy import model_policy

    env = C.LidarInFront(C.make(env_id, device=device), 8)
    expert = get_expert(env_id)
    act = None if params is None else model_policy(params, env.device)

    key = TF.key(seed)
    rng = np.random.RandomState(seed)
    obs_buf, lab_buf = [], []
    for ep in range(episodes):
        np.random.seed(seed * 100_000 + ep)
        obs = env.reset()
        for t in range(cap):
            a_exp = expert(env)
            obs_buf.append(np.asarray(obs, np.float32))
            lab_buf.append(a_exp)
            if act is None or rng.rand() < mix_expert:
                a = a_exp
            else:
                key, k = TF.split(key)
                a = act(k, obs)
            obs, r, done, _ = env.step(a)
            if done:
                break
    return np.stack(obs_buf), np.asarray(lab_buf, np.int64)


def sharpened(model, tau: float):
    """``model`` with its logits scaled by ``tau`` (``pi_out``'s weight and
    bias; a copy unless ``tau`` is 1): monotone and argmax-preserving."""
    if tau == 1:
        return model
    out = copy.deepcopy(model)
    with torch.no_grad():
        out.pi_out.weight.mul_(tau)
        out.pi_out.bias.mul_(tau)
    return out


def main(argv=None):
    """Run the rounds; returns ``{'best': (solve, return) or None,
    'seconds': {'collect', 'bc', 'eval'}}``."""
    p = argparse.ArgumentParser()
    p.add_argument("-env", default="NovelGridworld-Pogostick-v0")
    p.add_argument("-rounds", type=int, default=8)
    p.add_argument("-episodes_per_round", type=int, default=64)
    p.add_argument("-episode_cap", type=int, default=100)
    p.add_argument("-bc_steps", type=int, default=4000)
    p.add_argument("-bc_batch", type=int, default=512)
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-hidden", default="64,64")
    p.add_argument("-eval_episodes", type=int, default=128)
    p.add_argument("-demos", default="",
                   help="optional seed dataset .npz (ngx_torch.cli."
                        "record_demos layout); round 0 otherwise rolls the "
                        "expert")
    p.add_argument("-ckpt", default="")
    p.add_argument("-sharpen", default="1,2,4,8",
                   help="logit temperature sweep: each round also evaluates "
                        "the policy with pi_out scaled by these factors "
                        "(monotone, argmax-preserving — converts BC accuracy "
                        "into solve rate under the stochastic eval protocol) "
                        "and keeps the best-scoring variant")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-device", default="cuda", help=DEVICE_HELP)
    args = p.parse_args(argv)

    from ..ops import threefry as TF
    from ..ops.tables import resolve_device
    from ..presets import make_spec
    from ..rl.bc import load_demos, pretrain
    from ..rl.evaluate import make_eval
    from ..rl.models import ActorCritic
    from ..utils.checkpoint import save_checkpoint

    device = resolve_device(args.device)
    hidden = tuple(int(x) for x in args.hidden.split(","))
    spec = make_spec(args.env)
    run_eval = make_eval(spec, cap=args.episode_cap, device=device)
    secs = {"collect": 0.0, "bc": 0.0, "eval": 0.0}

    def collect(params, seed):
        t0 = time.perf_counter()
        out = collect_policy_labeled(
            args.env, params, hidden, args.episodes_per_round,
            args.episode_cap, seed, device=device)
        secs["collect"] += time.perf_counter() - t0
        return out

    if args.demos:
        obs, labels = load_demos(args.demos)
        print(f"seed dataset: {obs.shape[0]} frames from {args.demos}")
    else:
        obs, labels = collect(None, args.seed)
        print(f"round 0 (expert rollout): {obs.shape[0]} frames")

    model = ActorCritic.from_key(TF.key(args.seed), obs.shape[1],
                                 spec.n_actions, hidden).to(device)
    taus = [float(t) for t in args.sharpen.split(",")]
    best = None
    for rnd in range(args.rounds):
        t0 = time.perf_counter()
        model, m = pretrain(model, obs, labels, key=TF.key(args.seed + rnd),
                            steps=args.bc_steps, batch_size=args.bc_batch,
                            lr=args.lr)
        secs["bc"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        round_best = None
        for tau in taus:
            p_t = sharpened(model, tau)
            ev = run_eval(p_t, TF.key(args.seed * 7 + rnd),
                          args.eval_episodes)
            sc = (ev["solve_rate"], ev["mean_return"])
            if round_best is None or sc > round_best[0]:
                round_best = (sc, tau, p_t, ev)
        secs["eval"] += time.perf_counter() - t0
        sc, tau, p_t, ev = round_best
        print(f"round {rnd}: dataset={obs.shape[0]} "
              f"bc_acc={m['accuracy']:.2%} solve={ev['solve_rate']:.2%} "
              f"return={ev['mean_return']:.1f} (tau={tau:g})")
        if args.ckpt and (best is None or sc > best):
            best = sc
            save_checkpoint(os.path.join(args.ckpt, "best.pt"),
                            {"params": p_t.state_dict(),
                             "config": {"hidden": list(hidden),
                                        "solve_frac": ev["solve_rate"],
                                        "mean_ep_return": ev["mean_return"],
                                        "dagger_round": rnd,
                                        "sharpen_tau": tau}})
            print(f"  saved new best (solve={ev['solve_rate']:.2%})")
        if rnd == args.rounds - 1:
            break
        new_obs, new_lab = collect(model, args.seed + 1000 * (rnd + 1))
        obs = np.concatenate([obs, new_obs])
        labels = np.concatenate([labels, new_lab])
    print(f"best solve rate: {best[0]:.2%}" if best else "no checkpoint")
    print("seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    return {"best": best, "seconds": secs}


if __name__ == "__main__":
    main()
