"""Training CLI — the port of ``ngx/cli/train.py``: PPO with Monitor-style
CSV logs, best-model checkpoints (the reference's
SaveOnBestTrainingRewardCallback, reference tests/train.py:43-70), resume,
a behaviour-cloning warm start and anchor, mid-training novelty injection
(reference tests/train.py:73-89) and the curriculum chain (reference
tests/train_last_agent.py).

    python -m ngx_torch.cli.train -env NovelGridworld-Pogostick-v1 \\
        -steps 400000 -log results/pogo -ckpt agents/pogo
    python -m ngx_torch.cli.train \\
        -chain NovelGridworld-v2,NovelGridworld-v3,NovelGridworld-v4,NovelGridworld-v5 \\
        -chain_ckpts trained_agents_torch/chain -num_envs 8192 \\
        -reward_mode solve -best_metric solve \\
        -bc_anchor demos/NovelGridworld-v5.npz -ckpt agents/chain_solver

It runs on the card (``-device cuda``, the default) or, with ``-device
cpu``, on the kernels' plain twins.  Checkpoints are
:mod:`ngx_torch.utils.checkpoint` files: ``<ckpt>/best.pt``, ``final.pt``
and ``resume.pt`` (params and optimizer state, the ``-resume`` target);
``-chain_ckpts`` reads ``<dir>/<env_id>/best.pt``.  ``<log>/
progress.monitor.csv`` has a ``#{json}`` header line, then one row ``r, l,
t`` per update, as ngx's (its ``env_id`` is the trained env, the last
stage under ``-chain``).

``-rollout_backend``: ``auto`` and ``pallas`` both mean the CUDA kernel;
``xla`` is ngx's unfused acting loop, step by step in torch, for plain,
novelty and ``-chain`` runs alike (``ngx_torch.rl.train.make_train``,
``ngx_torch.rl.curriculum.make_train_chain``).  There is no compile step, so
ngx's fallback from a failed compile
of ``-updates_per_launch`` updates has no counterpart: here K only sets how
often the chain's pool is re-chained (once every K updates) and how many
updates' metrics are fetched at once.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import time
from collections import deque


def build_parser():
    p = argparse.ArgumentParser(prog="python -m ngx_torch.cli.train")
    p.add_argument("-env", default="NovelGridworld-Bow-v0")
    p.add_argument("-steps", type=int, default=400_000,
                   help="total env steps (reference budget: 400k)")
    p.add_argument("-num_envs", type=int, default=512)
    p.add_argument("-rollout", type=int, default=64)
    p.add_argument("-lr", type=float, default=2.5e-4)
    p.add_argument("-ent_coef", type=float, default=0.01)
    p.add_argument("-epochs", type=int, default=4)
    p.add_argument("-episode_cap", type=int, default=100)
    p.add_argument("-log", default="results/run")
    p.add_argument("-ckpt", default="")
    p.add_argument("-resume", default="",
                   help="resume from a '<ckpt>/resume.pt' checkpoint "
                        "(params + optimizer state)")
    p.add_argument("-pretrain", default="",
                   help="expert-demo .npz for a behaviour-cloning warm start "
                        "(reference tests/train.py:125-132)")
    p.add_argument("-pretrain_steps", type=int, default=500)
    p.add_argument("-inject_novelty_at", type=int, default=0,
                   help="inject -novelty after this many env steps (0=off)")
    p.add_argument("-novelty", default="remapaction")
    p.add_argument("-novelty_difficulty", default="easy")
    p.add_argument("-novelty_arg1", default="")
    p.add_argument("-novelty_arg2", default="")
    p.add_argument("-bc_anchor", default="",
                   help="demo .npz whose (obs, action) pairs anchor every "
                        "PPO minibatch with a cross-entropy term")
    p.add_argument("-bc_coef", type=float, default=0.05)
    p.add_argument("-reward_mode", default="env", choices=("env", "solve"),
                   help="'solve' trains on the solve-shaped reward (-1/step, "
                        "+reward_done only on goal termination)")
    p.add_argument("-best_metric", default="return",
                   choices=("return", "solve"),
                   help="what 'best' checkpoints track: mean episode return "
                        "or the solve fraction")
    p.add_argument("-chain", default="",
                   help="comma-separated env-id chain (reference "
                        "tests/train_last_agent.py:41): trains the LAST env "
                        "with every reset restoring a batched chain-terminal "
                        "state from the earlier stages (frozen policies from "
                        "-chain_ckpts, random actions otherwise)")
    p.add_argument("-chain_ckpts", default="",
                   help="dir holding per-stage checkpoints "
                        "(<env_id>/best.pt) for the frozen chain stages")
    p.add_argument("-updates_per_launch", type=int, default=8,
                   help="updates between two fetches of the metrics; the "
                        "chain's pool is re-chained once every this many "
                        "updates")
    p.add_argument("-rollout_backend", default="auto",
                   choices=("auto", "xla", "pallas"),
                   help="acting loop: auto and pallas both run the CUDA "
                        "kernel; xla the unfused loop (ngx's XLA backend)")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def _plain_dims(spec):
    """``(obs_dim, n_actions)`` of ``spec`` under LidarInFront, from one
    counter reset on the CPU (no device is touched)."""
    import ngx_torch as nt

    spec = nt.lidar_in_front(spec)
    state = nt.counter_reset(spec, 0, 0, 1, device="cpu")
    return int(nt.make_step(spec).get_obs(state).shape[1]), spec.n_actions


def validate(p, args):
    """Refuse, before any step, what cannot run: returns ``(cfg,
    num_updates, steps_per_update, inject_update, inject_spec)``."""
    import ngx_torch as nt
    from ngx_torch.rl.train import PPOConfig

    cfg = PPOConfig(env_id=args.env, num_envs=args.num_envs,
                    rollout_steps=args.rollout, lr=args.lr,
                    ent_coef=args.ent_coef, epochs=args.epochs,
                    episode_cap=args.episode_cap,
                    solve_shaped=args.reward_mode == "solve",
                    bc_coef=args.bc_coef if args.bc_anchor else 0.0)
    if args.chain:
        env_ids = [e.strip() for e in args.chain.split(",")]
        if args.env not in (env_ids[-1], p.get_default("env")):
            p.error("-env (if given) must equal the last -chain stage")
        cfg = dataclasses.replace(cfg, env_id=env_ids[-1])
    steps_per_update = cfg.num_envs * cfg.rollout_steps
    num_updates = max(1, args.steps // steps_per_update)
    inject_update = inject_spec = None
    if args.inject_novelty_at:
        if args.chain:
            # the injection rebuilds a plain make_train carry, which the
            # chain trainer's pool-carrying carry cannot continue from
            p.error("-chain and -inject_novelty_at are mutually exclusive")
        inject_update = args.inject_novelty_at // steps_per_update
        if not 1 <= inject_update < num_updates:
            p.error(
                f"-inject_novelty_at {args.inject_novelty_at} maps to "
                f"update {inject_update} of {num_updates} (one update = "
                f"num_envs*rollout = {steps_per_update} steps); it must "
                f"land strictly inside the run")
        inject_spec = nt.inject_novelty(
            nt.make_spec(args.env), args.novelty, args.novelty_difficulty,
            args.novelty_arg1, args.novelty_arg2)
        (d1, a1), (d2, a2) = (_plain_dims(nt.make_spec(args.env)),
                              _plain_dims(inject_spec))
        if (d1, a1) != (d2, a2):
            # continuing the SAME policy needs the same obs/action dims:
            # the reference's mid-training scenario is remapaction
            p.error(
                f"-inject_novelty_at cannot continue the trained policy "
                f"across '{args.novelty}': it changes the obs/action dims "
                f"(obs {d1} -> {d2}, actions {a1} -> {a2}).  To train under "
                f"this novelty, start a fresh run on the injected spec.")
    return cfg, num_updates, steps_per_update, inject_update, inject_spec


def restore_train_state(ts, path):
    """Load a ``resume.pt`` checkpoint's params and optimizer state into the
    train state ``ts`` (a full-fidelity resume)."""
    from ngx_torch.utils.checkpoint import restore_checkpoint

    tree = restore_checkpoint(path)
    ts.model.load_state_dict(tree["params"])
    ts.opt.load_state_dict(tree["opt_state"])
    return ts


def setup(args, cfg, bc_data):
    """``(carry, train_step, refresh)``: the trainer for ``args`` (the chain
    trainer under ``-chain``), its initial carry after ``-resume`` and
    ``-pretrain``, and the chain's pool refresh (None without a chain)."""
    import torch

    if args.chain:
        from ngx_torch.rl.curriculum import make_train_chain
        from ngx_torch.utils.checkpoint import restore_checkpoint

        env_ids = [e.strip() for e in args.chain.split(",")]
        stage_params = []
        for e in env_ids[:-1]:
            path = (os.path.join(args.chain_ckpts, e, "best.pt")
                    if args.chain_ckpts else "")
            if path and os.path.exists(path):
                stage_params.append(restore_checkpoint(path)["params"])
                print(f"chain stage {e}: frozen policy from {path}")
            else:
                stage_params.append(None)
                print(f"chain stage {e}: random actions (no checkpoint)")
        init, train_step = make_train_chain(
            cfg, env_ids, stage_params, rollout_backend=args.rollout_backend,
            bc_data=bc_data, device=args.device)
        refresh = train_step.refresh_pool
    else:
        from ngx_torch.rl.train import make_train

        init, train_step = make_train(
            cfg, rollout_backend=args.rollout_backend, bc_data=bc_data,
            device=args.device)
        refresh = None
    carry = init(args.seed)
    if args.resume:
        restore_train_state(carry[0], args.resume)
        print(f"resumed TrainState from {args.resume}")
    if args.pretrain:
        from ngx_torch.rl.bc import pretrain_from_npz

        _, m = pretrain_from_npz(
            carry[0].model, args.pretrain, steps=args.pretrain_steps,
            generator=torch.Generator().manual_seed(args.seed))
        print(f"BC pretrain: loss={m['loss']:.3f} acc={m['accuracy']:.2%}")
    return carry, train_step, refresh


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    cfg, num_updates, steps_per_update, inject_update, inject_spec = \
        validate(p, args)

    import torch

    from ngx_torch.rl.train import make_train
    from ngx_torch.utils.checkpoint import save_checkpoint

    bc_data = None
    if args.bc_anchor:
        from ngx_torch.rl.bc import load_demos

        bc_data = load_demos(args.bc_anchor)
        print(f"bc anchor: {bc_data[0].shape[0]} frames from "
              f"{args.bc_anchor} (coef {args.bc_coef})")

    os.makedirs(args.log, exist_ok=True)
    t0 = time.time()
    f = open(os.path.join(args.log, "progress.monitor.csv"), "w", newline="")
    f.write("#%s\n" % json.dumps({"t_start": t0, "env_id": cfg.env_id}))
    w = csv.DictWriter(f, fieldnames=("r", "l", "t"))
    w.writeheader()

    carry, train_step, refresh = setup(args, cfg, bc_data)
    K = max(1, args.updates_per_launch)
    window = deque(maxlen=10)     # trailing multi-update aggregation
    best = [None]

    def seed_of(u):
        return args.seed * 1_000_003 + u + 1

    def log_update(uidx, carry, m):
        count = max(m["ep_count"], 1.0)
        mean_ep = m["ep_return_sum"] / count
        solve = m["ep_solved"] / count
        # one short rollout window under-samples long (failing) episodes:
        # aggregate the counts over a trailing window of updates, and rank
        # 'best' checkpoints on the aggregate
        window.append((m["ep_solved"], m["ep_count"], m["ep_return_sum"]))
        w_count = max(sum(x[1] for x in window), 1.0)
        w_return = sum(x[2] for x in window) / w_count
        solve_agg = sum(x[0] for x in window) / w_count
        w.writerow({"r": round(mean_ep, 4),
                    "l": int(round(steps_per_update / count)),
                    "t": round(time.time() - t0, 4)})
        f.flush()
        print(f"steps {(uidx + 1) * steps_per_update}: "
              f"mean_ep_return={mean_ep:.2f} solve={solve:.0%} "
              f"(10-update agg {solve_agg:.0%}) "
              f"episodes={int(m['ep_count'])} entropy={m['entropy']:.3f}")
        score = ((solve_agg, w_return) if args.best_metric == "solve"
                 else (mean_ep,))
        if args.ckpt and m["ep_count"] > 0 and (best[0] is None
                                                or score > best[0]):
            best[0] = score
            save_checkpoint(os.path.join(args.ckpt, "best.pt"), {
                "params": carry[0].model.state_dict(),
                "config": vars(args) | {"hidden": list(cfg.hidden),
                                        "mean_ep_return": mean_ep,
                                        "solve_frac": solve_agg}})
            print(f"  saved new best ({args.best_metric}={score[0]:.2f})")

    def run_updates(n, carry, step_fn, offset=0):
        u = 0
        while u < n:
            k = min(K, n - u)
            if refresh is not None:
                carry = refresh(carry, args.seed * 1_000_003 + 500_000
                                + offset + u)
            stacked = []
            for i in range(k):
                carry, m = step_fn(carry, seed_of(offset + u + i))
                stacked.append(torch.stack([v.to(torch.float64)
                                            for v in m.values()]))
            names = list(m)
            for i, row in enumerate(torch.stack(stacked).cpu().tolist()):
                log_update(offset + u + i, carry, dict(zip(names, row)))
            u += k
        return carry

    if inject_update:
        carry = run_updates(inject_update, carry, train_step)
        # the novelty-response experiment: rebuild the env mid-training
        # (RemapActionOnStep, reference tests/train.py:73-89)
        print(f"injecting novelty {args.novelty} at update {inject_update}")
        init2, train_step2 = make_train(
            cfg, spec_override=inject_spec,
            rollout_backend=args.rollout_backend, device=args.device)
        carry2 = init2(args.seed * 1_000_003 + 999)
        carry = (carry[0],) + carry2[1:]
        # neither the trailing window nor 'best' mixes the two regimes
        window.clear()
        best[0] = None
        carry = run_updates(num_updates - inject_update, carry, train_step2,
                            offset=inject_update)
    else:
        carry = run_updates(num_updates, carry, train_step)

    if args.ckpt:
        model, opt = carry[0].model, carry[0].opt
        save_checkpoint(os.path.join(args.ckpt, "final.pt"), {
            "params": model.state_dict(),
            "config": vars(args) | {"hidden": list(cfg.hidden)}})
        save_checkpoint(os.path.join(args.ckpt, "resume.pt"), {
            "params": model.state_dict(), "opt_state": opt.state_dict()})
        print("final checkpoint saved to",
              os.path.join(args.ckpt, "final.pt"))
    f.close()


if __name__ == "__main__":
    main()
