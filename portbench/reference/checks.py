"""The comparisons that decide ``correct``, and the stand-ins for the
program that prove them: the reference itself in a lower precision (the
control) and with a planted fault.

Everything here is plain torch on the frozen copies beside this file: it
imports nothing of the program.  It takes the cell's configuration, the
seed's key and the raw files the configuration names, works out again
what the program derived from them, and reads the program's outputs only
to judge them.  Float32 matrix products run with TF32 off, as the
configurations state; the control turns TF32 on."""

from __future__ import annotations

import contextlib
import dataclasses
import statistics

import numpy as np
import torch

from . import acting, ppo as P
from .chain import as_policy, make_chain
from .evaluate import make_eval
from .frozen.core.reset import make_reset
from .frozen.core.step import make_step
from .frozen.ops import threefry as TF
from .frozen.presets import make_spec
from .frozen.rl.models import ActorCritic
from .frozen.transforms import lidar_in_front
from .stepping import run as stepping_run

POOL_SLOTS = 4
# a leaf whose first gradient is under this share of the median leaf's
# moves by round-off alone and is left out of the change's comparison
ROUNDING_LEAF = 1e-3


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matrix products with TF32 on or off, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def state_rows(state) -> torch.Tensor:
    """An env state as int64 rows on the host, every field bit for bit (a
    float field by its bits), for an exact comparison."""
    cols = []
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        if t.dtype == torch.float32:
            t = t.view(torch.int32)
        cols.append(t.to(torch.int64).reshape(t.shape[0], -1))
    return torch.cat(cols, 1).cpu()


def rows_differ(a, b) -> int:
    if a.shape != b.shape:
        return int(max(a.shape[0], b.shape[0]))
    return int((a != b).any(1).sum())


def load_params(path):
    return torch.load(path, map_location="cpu", weights_only=True)["params"]


def worst_leaf(got, want, keep=None) -> float:
    """The widest gap between two sets of leaves, by leaf: ``| ||got_l|| -
    ||want_l|| |`` over the larger of ``||want_l||`` and the median
    leaf's norm, over the leaves ``keep`` (all by default)."""
    norms = [float(w.double().norm()) for w in want]
    median = statistics.median(norms)
    idx = range(len(want)) if keep is None else keep
    worst = 0.0
    for i in idx:
        g = float(got[i].double().norm())
        worst = max(worst, abs(g - norms[i]) / max(norms[i], median, 1e-30))
    return worst


# ---- the train cells -------------------------------------------------------
def train_updates(config, key, n: int, device, given=None, tf32=False,
                  fault=None, root="."):
    """The reference's first ``n`` updates of the ``train`` traffic from
    ``key``.  Returns a record laid out as the program's (``theta0``,
    ``rollouts``, ``terms``, ``grad1``, ``theta``, ``pools``, ``start``)
    and, with ``given`` (the program's rollouts), ``mismatch`` and
    ``gap``: how the given trajectories read against the reference's env
    and policy.  Without ``given`` this is a stand-in for the program:
    its own actions, in TF32 where ``tf32`` and with ``fault`` planted."""
    ppo = dict(config["ppo"])
    B, T, cap = ppo["num_envs"], ppo["rollout_steps"], ppo["episode_cap"]
    hidden = tuple(ppo["hidden"])
    block = 256 if B % 256 == 0 else 128
    chain = config.get("chain")
    key = TF.as_key(key)
    rec = dict(rollouts=[], terms=[], grad1=None, theta=None, pools=[])
    mismatch, gap = 0, 0.0
    bc = None
    with precision(tf32):
        if chain:
            stages = [load_params(f"{root}/" + config["stage_policies"]
                                  .format(env=e)) for e in chain[:-1]]
            P_rows = config["pool_size"]
            chain_fn, spec = make_chain(chain, stages, P_rows, cap, device)
            if ppo.get("bc_coef", 0) > 0:
                with np.load(f"{root}/" + config["bc_anchor"]) as z:
                    bc = (torch.as_tensor(np.asarray(z["obs"], np.float32),
                                          device=device),
                          torch.as_tensor(np.asarray(z["actions"], np.int64)
                                          .reshape(-1), device=device))
            k_env, k_net, k_idx = TF.split(key, 3)
            pool, pool_obs = chain_fn(k_env)
            idx = TF.randint(k_idx.to(device), (B,), 0, P_rows).long()
            state = pool.take(idx)
            base = state.step_count.clone()
            rec["start"] = state_rows(state)
            obs_dim = pool_obs.shape[1]
        else:
            spec = lidar_in_front(make_spec(config["env_id"]))
            k_env, k_net = TF.split(key)
            state, obs = make_reset(spec, device)(TF.split(k_env.to(device),
                                                           B))
            base = None
            obs_dim = obs.shape[1]
        get_obs = make_step(spec, with_obs=False).get_obs
        model = ActorCritic.from_key(k_net, obs_dim, spec.n_actions,
                                     hidden).to(device)
        opt = P.make_opt(ppo, model)
        params = list(model.parameters())
        rec["theta0"] = [p.detach().cpu().clone() for p in params]
        for u in range(n):
            key_u = TF.fold_in(key, u + 1)
            pool_r = None
            if chain:
                if u % config["updates_per_refresh"] == 0:
                    pool, pool_obs = chain_fn(TF.fold_in(key, 500_000 + u))
                    if u == 0:
                        rec["pools"].append(state_rows(pool))
                _, k_roll, k_upd = TF.split(key_u, 3)
                k_seed, k_idx = TF.split(k_roll)
                seed = P.draw_seed(k_seed)
                rows = TF.randint(k_idx.to(device), (B, POOL_SLOTS), 0,
                                  P_rows).long()
                pool_r = pool.take(rows.reshape(-1))
            else:
                k_roll, k_upd = TF.split(key_u)
                seed = P.draw_seed(k_roll)
            pi = [(w.detach(), b.detach()) for w, b in model.pi_layers()]
            g = None if given is None else [x.to(device) for x in given[u]]
            out = acting.act(spec, state, pi, seed, T, block, cap, pool_r,
                             base, given=g)
            state = out["state"]
            base = out["base"] if chain else None
            if given is not None:
                mismatch += int(out["mismatch"])
                gap = max(gap, float(out["gap"]))
            action = out["action"]
            if fault == "alter" and given is None:
                action = action.clone()
                action[0, 0] = (action[0, 0] + 1) % spec.n_actions
            perms = P.epoch_perms(ppo["epochs"], k_upd, T * B, device)
            terms, grads = P.learn(
                ppo, spec, model, opt,
                (out["obs_t"], action, out["reward"], out["done"]),
                get_obs(state).to(torch.float32), perms, bc,
                fault="half" if fault == "half" else None)
            rec["rollouts"].append([out["obs_t"].cpu(), action.cpu(),
                                    out["reward"].cpu(), out["done"].cpu()])
            rec["terms"].append(terms.cpu())
            if u == 0:
                rec["grad1"] = [x.cpu() for x in grads]
        rec["theta"] = ([t.clone() for t in rec["theta0"]]
                        if fault == "unchanged" and given is None
                        else [p.detach().cpu().clone() for p in params])
    rec["mismatch"], rec["gap"] = mismatch, gap
    return rec


def compare_train(config, got, ref) -> dict:
    """The numbers compared in a train cell: ``got`` is the program's (or a
    stand-in's) record, ``ref`` the reference's record that judged it."""
    ppo = config["ppo"]

    def loss(t):
        t = t.double()
        return float(t[0] + ppo["vf_coef"] * t[1] - ppo["ent_coef"] * t[2])

    loss_gap = max(abs(loss(a) - loss(b)) / max(abs(loss(b)), 1e-12)
                   for a, b in zip(got["terms"], ref["terms"]))
    g_norms = [float(g.double().norm()) for g in ref["grad1"]]
    median = statistics.median(g_norms)
    keep = [i for i, n in enumerate(g_norms) if n >= ROUNDING_LEAF * median]
    d_got = [a - b for a, b in zip(got["theta"], got["theta0"])]
    d_ref = [a - b for a, b in zip(ref["theta"], ref["theta0"])]
    numbers = {
        "trajectory_mismatch": float(ref["mismatch"]),
        "action_score_gap": ref["gap"],
        "loss_gap": loss_gap,
        "first_grad_gap": (float("inf") if got["grad1"] is None
                           else worst_leaf(got["grad1"], ref["grad1"])),
        "param_change_gap": worst_leaf(d_got, d_ref, keep),
    }
    if config.get("chain"):
        numbers["pool_rows_mismatch"] = float(
            rows_differ(got["start"], ref["start"])
            + sum(rows_differ(a, b) for a, b in zip(got["pools"],
                                                   ref["pools"])))
    return numbers


def check_train(config, traffic, key, record, device, root=".") -> dict:
    """The numbers of a train cell for the program's ``record``."""
    ref = train_updates(config, key, len(record["rollouts"]), device,
                        given=record["rollouts"], root=root)
    return compare_train(config, record, ref)


def standin_train(config, traffic, key, device, tf32=False, fault=None,
                  root=".") -> dict:
    """The numbers a train cell reads when the reference, in TF32 or with
    ``fault`` planted, stands in for the program."""
    n = int(traffic["checked_updates"])
    got = train_updates(config, key, n, device, tf32=tf32, fault=fault,
                        root=root)
    ref = train_updates(config, key, n, device, given=got["rollouts"],
                        root=root)
    return compare_train(config, got, ref)


# ---- the stepping cells ----------------------------------------------------
def check_stepping(config, traffic, samples, device) -> dict:
    """``samples``: ``(seed, state rows, mean_reward)`` of calls the
    program (or a stand-in) answered.  Numbers: the state rows that differ
    from the reference's, and the widest relative gap of the mean reward;
    both infinite where there is nothing to judge."""
    if not samples:
        # nothing was there to judge: no run is correct by default
        return {"state_rows_mismatch": float("inf"),
                "mean_reward_gap": float("inf")}
    spec = lidar_in_front(make_spec(config["env_id"]))
    B, T = traffic["batch"], traffic["steps"]
    block = 512 if B % 512 == 0 else B
    differ, gap = 0, 0.0
    for seed, rows, mean in samples:
        state, ref_mean = stepping_run(spec, B, T, seed, block, device)
        differ += rows_differ(rows, state_rows(state))
        ref_mean = float(ref_mean)
        gap = max(gap, abs(mean - ref_mean) / max(abs(ref_mean), 1e-12))
    return {"state_rows_mismatch": float(differ), "mean_reward_gap": gap}


def standin_stepping(config, traffic, seeds, device, sum_dtype) -> dict:
    spec = lidar_in_front(make_spec(config["env_id"]))
    B, T = traffic["batch"], traffic["steps"]
    block = 512 if B % 512 == 0 else B
    samples = []
    for seed in seeds:
        state, mean = stepping_run(spec, B, T, seed, block, device,
                                   sum_dtype=sum_dtype)
        samples.append((seed, state_rows(state), float(mean)))
    return check_stepping(config, traffic, samples, device)


# ---- the evaluation cells --------------------------------------------------
EVAL_KEYS = ("mean_return", "solve_rate", "done_rate", "mean_length")


def eval_run(config, traffic, key, device, tf32=False, root=".",
             logits=None):
    """One evaluation on ``key``, a ``(seed, i)`` pair: ``fold_in(key(seed),
    i)``; ``logits`` collects each step's."""
    seed, fold = key
    spec = lidar_in_front(make_spec(config["env_id"]))
    with precision(tf32):
        model = as_policy(load_params(f"{root}/" + config["eval_policy"]),
                          device)
        return make_eval(spec, traffic["cap"], device)(
            model, TF.fold_in(TF.key(seed), fold), traffic["episodes"],
            logits)


def check_eval(config, traffic, samples, device, root=".") -> dict:
    """``samples``: ``(key, metrics, logits)`` of evaluations the program
    (or a stand-in) answered.  Numbers: the widest gap of any of the four
    metrics, and the widest gap of a policy logit the program computed at
    a step from the reference's at that step (infinite where they took
    different numbers of steps); both infinite where there is nothing to
    judge."""
    if not samples:
        return {"eval_metric_gap": float("inf"), "logit_gap": float("inf")}
    gap = logit_gap = 0.0
    for key, got, got_logits in samples:
        ref_logits = []
        ref = eval_run(config, traffic, key, device, root=root,
                       logits=ref_logits)
        gap = max(gap, max(abs(got[k] - ref[k]) for k in EVAL_KEYS))
        ref_logits = torch.stack(ref_logits).cpu()
        got_logits = got_logits.cpu()
        logit_gap = max(logit_gap, float("inf")
                        if got_logits.shape != ref_logits.shape
                        else float((got_logits - ref_logits).abs().max()))
    return {"eval_metric_gap": gap, "logit_gap": logit_gap}


def standin_eval(config, traffic, keys, device, root=".") -> dict:
    samples = []
    for k in keys:
        logits = []
        out = eval_run(config, traffic, k, device, tf32=True, root=root,
                       logits=logits)
        samples.append((k, out, torch.stack(logits)))
    return check_eval(config, traffic, samples, device, root=root)
