"""Evaluate every shipped agent of the port and write its eval report — the
port of ``ngx/cli/eval_agents.py``.

    python -m ngx_torch.cli.eval_agents -episodes 128 \\
        -agents trained_agents_torch -out results/eval_torch.json \\
        -md results/EVAL_torch.md

For each env with a checkpoint ``-agents/<env>/{best,final}.pt`` this runs
``episodes`` batched episodes (100-step cap, the reference's eval drivers,
enjoy.py:87,107) of the trained policy and of the uniform-random baseline
(:func:`~ngx_torch.rl.evaluate.evaluate_checkpoint`), the scripted expert
(:func:`~ngx_torch.rl.evaluate.evaluate_expert`), the solver under
``-agents/<env>_solver/`` where there is one, and the reference's SB2 zip
``-ref_agents/<env>.zip`` where there is one
(:func:`~ngx_torch.rl.evaluate.evaluate_sb2_zip`).  When
``-agents/chain/<e>/best.pt`` exists for v2-v5 the chain section
evaluates the chain agents under the chain protocol
(:func:`~ngx_torch.rl.curriculum.evaluate_chain`, whose stage 0 is
ngx's native reset).  It writes the JSON report and a
markdown table; every number in either is one this run computed.

The evaluators run on ``-device``, ``cuda`` by default, where ngx's driver
takes ``-platform`` (default cpu).  Every row draws from ngx's keys
(:mod:`ngx_torch.ops.threefry`) from ``-seed`` as
ngx's evaluators do, so the report is ngx's (``results/eval.json``, the
chain rows of ``docs/EVAL.md``), up to a Gumbel near-tie between the
port's logits and flax's; the expert rows draw from ``np.random`` only and
equal ngx's exactly.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .enjoy import DEVICE_HELP

ENV_IDS = [
    "NovelGridworld-v0", "NovelGridworld-v1", "NovelGridworld-v2",
    "NovelGridworld-v3", "NovelGridworld-v4", "NovelGridworld-v5",
    "NovelGridworld-v6", "NovelGridworld-Bow-v0", "NovelGridworld-Bow-v1",
    "NovelGridworld-Pogostick-v0", "NovelGridworld-Pogostick-v1",
]
CHAIN = ["NovelGridworld-v2", "NovelGridworld-v3", "NovelGridworld-v4",
         "NovelGridworld-v5"]
# the reference repo, where its tests find it; its SB2 zips are under
# trained_agents/
_REFERENCE = os.environ.get("NGX_REFERENCE_PATH", "")


def find_checkpoint(base: str):
    """``<base>/best.pt``, else ``<base>/final.pt``, else None."""
    return next((os.path.join(base, k) for k in ("best.pt", "final.pt")
                 if os.path.exists(os.path.join(base, k))), None)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-agents", default="trained_agents_torch")
    p.add_argument("-ref_agents",
                   default=(os.path.join(_REFERENCE, "trained_agents")
                            if _REFERENCE else ""),
                   help="dir of the reference's SB2 .zip checkpoints "
                        "(v0-v4); adds a 'reference' row per env when "
                        "<dir>/<env>.zip exists ('' disables; default "
                        "$NGX_REFERENCE_PATH/trained_agents)")
    p.add_argument("-episodes", type=int, default=128)
    p.add_argument("-episode_cap", type=int, default=100)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-out", default="results/eval_torch.json")
    p.add_argument("-md", default="results/EVAL_torch.md")
    p.add_argument("-envs", default="", help="comma list; default all 11")
    p.add_argument("-device", default="cuda", help=DEVICE_HELP)
    args = p.parse_args(argv)

    from ..ops.tables import resolve_device
    from ..rl.evaluate import (evaluate_checkpoint, evaluate_expert,
                               evaluate_sb2_zip)

    device = resolve_device(args.device)
    kw = dict(episodes=args.episodes, cap=args.episode_cap, seed=args.seed,
              device=device)
    env_ids = args.envs.split(",") if args.envs else ENV_IDS
    report = {"episodes": args.episodes, "episode_cap": args.episode_cap,
              "seed": args.seed, "envs": {}}
    seconds = {}
    for env_id in env_ids:
        ckpt = find_checkpoint(os.path.join(args.agents, env_id))
        if ckpt is None:
            print(f"{env_id}: no checkpoint under "
                  f"{os.path.join(args.agents, env_id)} — skipped")
            continue
        t0 = time.time()
        res = evaluate_checkpoint(env_id, ckpt, **kw)
        res["checkpoint"] = os.path.relpath(ckpt, args.agents)
        # the scripted expert's solve/return ceiling under the same protocol
        t1 = time.time()
        res["expert"] = evaluate_expert(env_id, **kw)
        t2 = time.time()
        # the SOLVER variant (trained with -best_metric solve on envs where
        # reward farming out-earns the goal)
        sckpt = find_checkpoint(os.path.join(args.agents, env_id + "_solver"))
        if sckpt is not None:
            res["solver"] = evaluate_checkpoint(
                env_id, sckpt, include_random=False, **kw)["trained"]
            res["solver_checkpoint"] = os.path.relpath(sckpt, args.agents)
        # the reference's shipped SB2 agent, replayed through the port
        # (reference enjoy.py:49-72; plain-npz MLP weights, ngx_torch.rl.sb2)
        ref_zip = os.path.join(args.ref_agents, env_id + ".zip")
        if args.ref_agents and os.path.exists(ref_zip):
            res["reference"] = evaluate_sb2_zip(env_id, ref_zip, **kw)
        report["envs"][env_id] = res
        t3 = time.time()
        seconds[env_id] = {"trained": t1 - t0, "expert": t2 - t1,
                           "solver+reference": t3 - t2}
        t, r, e = res["trained"], res["random"], res["expert"]
        ref = res.get("reference")
        ref_s = (f" | ref-sb2 return={ref['mean_return']:.1f} "
                 f"solve={ref['solve_rate']:.0%}" if ref else "")
        print(f"{env_id}: trained return={t['mean_return']:.1f} "
              f"solve={t['solve_rate']:.0%} | expert "
              f"return={e['mean_return']:.1f} solve={e['solve_rate']:.0%} "
              f"| random return={r['mean_return']:.1f} "
              f"solve={r['solve_rate']:.0%}{ref_s} ({t3 - t0:.0f}s)")

    chain_dir = os.path.join(args.agents, "chain")
    if all(os.path.exists(os.path.join(chain_dir, e, "best.pt"))
           for e in CHAIN):
        # the chain agents LIVE under the chain protocol (per-stage 100-step
        # budgets, enjoy.py:87,107); skipped when any stage checkpoint is
        # missing, so the per-env report above is never discarded
        from ..rl.curriculum import evaluate_chain
        from ..utils.checkpoint import restore_checkpoint

        t0 = time.time()
        params = [restore_checkpoint(os.path.join(chain_dir, e, "best.pt"))
                  ["params"] for e in CHAIN]
        report["chain"] = evaluate_chain(CHAIN, params[:-1], params[-1],
                                         **kw)
        solver_path = os.path.join(args.agents, "chain_solver_v5", "best.pt")
        if os.path.exists(solver_path):
            report["chain_solver"] = evaluate_chain(
                CHAIN, params[:-1], restore_checkpoint(solver_path)["params"],
                **kw)
        seconds["chain"] = time.time() - t0
        print(f"chain {' -> '.join(CHAIN)}: {report['chain']}; solver "
              f"{report.get('chain_solver')} ({seconds['chain']:.0f}s)")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print("wrote", args.out)
    if args.md:
        write_markdown(report, args)
        print("wrote", args.md)
    report["seconds"] = seconds
    return report


def write_markdown(report, args):
    """The report as a markdown table: the port's modules and checkpoints,
    and only the numbers in ``report``."""
    lines = [
        "# Agent evaluation (ngx_torch)",
        "",
        f"Every agent under `{args.agents}/` evaluated for "
        f"**{args.episodes} episodes** ({args.episode_cap}-step cap, the "
        "reference's eval cap — `enjoy.py:87,107`) against the "
        "uniform-random baseline.  Generated by `python -m "
        f"ngx_torch.cli.eval_agents` (seed {args.seed}, device "
        f"{args.device}); raw numbers in `{args.out}`.",
        "",
        "An episode is *solved* when it ends before the cap with a "
        "positive terminal reward above half the goal reward (the goal step "
        "pays +50 on every env; other terminations pay at most +10 or less "
        "than zero).",
        "",
        "`expert` = the scripted expert policy (`ngx_torch/rl/experts.py`), "
        "run through the single-env facade.  `ref-SB2` = the reference's "
        "own stable-baselines-2 checkpoint (v0–v4 only, read as plain npz "
        "by `ngx_torch/rl/sb2.py`) replayed through the port.  Trained "
        "policies, the random baseline and the chain draw from the JAX "
        "reference's keys (`ngx_torch/ops/threefry.py`) "
        f"from seed {args.seed}, as the reference's evaluators do.",
        "",
        "| Env | trained return | trained solve % | expert return | "
        "expert solve % | ref-SB2 return | ref-SB2 solve % | "
        "random return | random solve % | ckpt |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]

    def cells(row):
        if row is None:
            return "— | —"
        return f"{row['mean_return']:.1f} | {row['solve_rate']:.0%}"

    for env_id, res in report["envs"].items():
        lines.append(
            f"| {env_id} | {cells(res['trained'])} | "
            f"{cells(res.get('expert'))} | {cells(res.get('reference'))} "
            f"| {cells(res['random'])} | {res['checkpoint']} |")
    solver_rows = [(e, r) for e, r in report["envs"].items() if "solver" in r]
    if solver_rows:
        lines += [
            "",
            "## Solver variants",
            "",
            "On the farming-dominated envs an additional SOLVER checkpoint "
            f"(`{args.agents}/<env>_solver/`) maximizes solve rate instead "
            "of return: PPO with the solve-shaped reward (`-reward_mode "
            "solve`: -1/step, +50 only on goal termination), a BC anchor "
            "over expert and DAgger-labeled frames, and a BC warm start.",
            "",
            "| Env | solver return | solver solve % | ckpt |",
            "|---|---|---|---|",
        ]
        for env_id, res in solver_rows:
            s = res["solver"]
            lines.append(
                f"| {env_id} | {s['mean_return']:.1f} | "
                f"{s['solve_rate']:.0%} | {res['solver_checkpoint']} |")
    if "chain" in report:
        chain = report["chain"]
        lines += [
            "",
            "## Curriculum chain (reference `tests/train_last_agent.py`)",
            "",
            "The chain agents under "
            f"`{args.agents}/chain/` (`python -m ngx_torch.cli.train -chain "
            "v2,v3,v4,v5 -chain_ckpts ...`, `ngx_torch/rl/curriculum.py`): "
            "each stage trained from chain-terminal states restored from "
            "the previous stages' frozen policies.  Under the chain "
            "protocol (earlier stages played by their frozen policies, the "
            "final policy rolled from the restored states with its own "
            f"{args.episode_cap}-step budget — "
            "`ngx_torch.rl.curriculum.evaluate_chain`, "
            f"{args.episodes} chains, seed {args.seed}), the chain-trained "
            f"v5 agent scores **solve {chain['solve_rate']:.0%}, mean "
            f"return {chain['mean_return']:.1f}** (solved counts goal "
            "terminations only).",
        ]
        if "chain_solver" in report:
            cs = report["chain_solver"]
            lines += [
                "",
                f"The chain SOLVER (`{args.agents}/chain_solver_v5/`, the "
                "solver recipe on the chain trainer) scores **solve "
                f"{cs['solve_rate']:.0%}, mean return "
                f"{cs['mean_return']:.1f}** under the same protocol.",
            ]
    lines += [
        "",
        "Notes: the reference ships SB2 checkpoints for v0–v4 only and no "
        "eval evidence for any of them; their rows here replay those "
        "weights on the port's dynamics.  The expert row is the measured "
        "return of a *solving* policy under the cap; a trained return above "
        "the expert's at a low solve rate is reward farming (repeatable "
        "craft-and-extract loops out-earning the goal bonus under the cap), "
        "which the solver rows avoid.",
    ]
    os.makedirs(os.path.dirname(args.md) or ".", exist_ok=True)
    with open(args.md, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
