"""The fence novelty's cells in plain torch: the fenced spec, ngx's keyed
pool-mode train step, the stepping run on the fenced spec, the comparisons
that decide ``correct`` there and the stand-ins that prove them.

A configuration with ``novelty`` (``[name, difficulty, material]``) trains
on ``lidar_in_front(inject_novelty(make_spec(env_id), *novelty))``.  Its
reset has an edit, so the trainer runs in pool mode (ngx's rule,
``train.py:330-346``): ``k_env, k_net = split(key)``; the start states are
ngx's native reset, edit included, over ``split(k_env, B)``; update ``u``
takes ``k_roll, k_upd = split(fold_in(key, u + 1))``, ``k_seed, k_pool =
split(k_roll)``, draws a fresh pool of ``B * R`` counter resets at ``ctr =
0`` in one RNG block of the pool seed ``randint(k_pool, (), 0, 2^31 -
1)``, acts from that pool with every env's base at 0 and learns as the
plain cell does.

Frozen from the port's ``rl/train.py`` (``make_train``'s keyed pool branch
and ``draw_pool``) and ``ops/rollout.py`` (``pool_reset``), on the frozen
copies beside this file; it imports nothing of the program.  Float32
matrix products run with TF32 off; the control turns TF32 on."""

from __future__ import annotations

import torch

from . import acting, checks, ppo as P
from .frozen.core.reset import ResetTables, make_reset, reset_rows
from .frozen.core.step import make_step
from .frozen.novelty import inject_novelty
from .frozen.ops import threefry as TF
from .frozen.ops.rng import block_streams
from .frozen.presets import make_spec
from .frozen.rl.models import ActorCritic
from .frozen.transforms import lidar_in_front
from .stepping import run as stepping_run

FAULTS = ("half", "alter", "unchanged", "pool")
# the numbers the train cell compares
NUMBERS = ("trajectory_mismatch", "pool_rows_mismatch", "action_score_gap",
           "loss_gap", "first_grad_gap", "param_change_gap")


def fenced_spec(config):
    """The configuration's LidarInFront spec under its novelty."""
    return lidar_in_front(inject_novelty(make_spec(config["env_id"]),
                                         *config["novelty"]))


def draw_pool(spec, n: int, seed: int, device):
    """The trainer's pool: ``n`` counter resets at ``ctr = 0``, rows
    ``0..n-1`` of one RNG block under ``seed``."""
    seeds, rows = block_streams(seed, n, n, device)
    return reset_rows(ResetTables(spec), seeds, 0, rows)


def _alter_row(pool, row: int):
    """``pool`` with one map cell of row ``row`` changed (a planted
    fault)."""
    m = pool.map.clone()
    m[row, 0] += 1
    return pool.replace(map=m)


# ---- the train cell --------------------------------------------------------
def train_updates(config, key, n: int, device, given=None, tf32=False,
                  fault=None):
    """The reference's first ``n`` updates of the ``train`` traffic from
    ``key``, laid out as the program's record (``theta0``, ``rollouts``,
    ``terms``, ``grad1``, ``theta``, ``pools``: the first update's pool as
    rows) with, given the program's rollouts, ``mismatch`` and ``gap`` (as
    :func:`checks.train_updates`).  Without ``given`` it stands in for the
    program: its own actions, in TF32 where ``tf32``, with ``fault`` (one
    of :data:`FAULTS`) planted; 'pool' alters a map cell of the pool's row
    0, which env 0 restores first, in the pool it acts from and
    records."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"fault {fault!r} is not one of {FAULTS}")
    ppo = dict(config["ppo"])
    B, T, cap = ppo["num_envs"], ppo["rollout_steps"], ppo["episode_cap"]
    R = int(config["pool_slots"])
    block = 256 if B % 256 == 0 else 128
    spec = fenced_spec(config)
    key = TF.as_key(key)
    rec = dict(rollouts=[], terms=[], grad1=None, theta=None, pools=[])
    mismatch, gap = 0, 0.0
    with checks.precision(tf32):
        k_env, k_net = TF.split(key)
        state, obs = make_reset(spec, device)(TF.split(k_env.to(device), B))
        get_obs = make_step(spec, with_obs=False).get_obs
        model = ActorCritic.from_key(k_net, obs.shape[1], spec.n_actions,
                                     tuple(ppo["hidden"])).to(device)
        opt = P.make_opt(ppo, model)
        params = list(model.parameters())
        rec["theta0"] = [p.detach().cpu().clone() for p in params]
        for u in range(n):
            k_roll, k_upd = TF.split(TF.fold_in(key, u + 1))
            k_seed, k_pool = TF.split(k_roll)
            pool = draw_pool(spec, B * R, P.draw_seed(k_pool), device)
            if fault == "pool" and given is None:
                pool = _alter_row(pool, 0)
            if u == 0:
                rec["pools"].append(checks.state_rows(pool))
            pi = [(w.detach(), b.detach()) for w, b in model.pi_layers()]
            g = None if given is None else [x.to(device) for x in given[u]]
            out = acting.act(spec, state, pi, P.draw_seed(k_seed), T, block,
                             cap, pool, None, given=g)
            state = out["state"]
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
                get_obs(state).to(torch.float32), perms, None,
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
    """:func:`checks.compare_train`'s numbers and ``pool_rows_mismatch``:
    the recorded pools' rows that differ from the reference's (infinite
    where the program recorded another number of pools)."""
    numbers = checks.compare_train(config, got, ref)
    if len(got["pools"]) != len(ref["pools"]):
        numbers["pool_rows_mismatch"] = float("inf")
    else:
        numbers["pool_rows_mismatch"] = float(sum(
            checks.rows_differ(a, b) for a, b in zip(got["pools"],
                                                     ref["pools"])))
    return numbers


def obs_width(config) -> int:
    """The width of the fenced spec's LidarInFront observation."""
    spec = fenced_spec(config)
    _, obs = make_reset(spec, "cpu")(TF.split(TF.key(0), 1))
    return obs.shape[1]


def check_train(config, traffic, key, record, device) -> dict:
    """The numbers of the train cell for the program's ``record``; every
    number infinite where its trajectories' observations are not the
    fenced spec's width (the program ran another spec)."""
    width = obs_width(config)
    if any(r[0].shape[-1] != width for r in record["rollouts"]):
        return dict.fromkeys(NUMBERS, float("inf"))
    ref = train_updates(config, key, len(record["rollouts"]), device,
                        given=record["rollouts"])
    return compare_train(config, record, ref)


def standin_train(config, traffic, key, device, tf32=False,
                  fault=None) -> dict:
    """The numbers the train cell reads when the reference, in TF32 or with
    ``fault`` planted, stands in for the program."""
    n = int(traffic["checked_updates"])
    got = train_updates(config, key, n, device, tf32=tf32, fault=fault)
    ref = train_updates(config, key, n, device, given=got["rollouts"])
    return compare_train(config, got, ref)


# ---- the stepping cell -----------------------------------------------------
def check_stepping(config, traffic, samples, device) -> dict:
    """:func:`checks.check_stepping` on the fenced spec: ``samples`` are
    ``(seed, state rows, mean_reward)`` of calls the program (or a
    stand-in) answered."""
    if not samples:
        return {"state_rows_mismatch": float("inf"),
                "mean_reward_gap": float("inf")}
    spec = fenced_spec(config)
    B, T = traffic["batch"], traffic["steps"]
    block = 512 if B % 512 == 0 else B
    differ, gap = 0, 0.0
    for seed, rows, mean in samples:
        state, ref_mean = stepping_run(spec, B, T, seed, block, device)
        differ += checks.rows_differ(rows, checks.state_rows(state))
        ref_mean = float(ref_mean)
        gap = max(gap, abs(mean - ref_mean) / max(abs(ref_mean), 1e-12))
    return {"state_rows_mismatch": float(differ), "mean_reward_gap": gap}


def standin_stepping(config, traffic, seeds, device, sum_dtype) -> dict:
    """The numbers the stepping cell reads when the reference, with its
    reward sums in ``sum_dtype``, answers the calls ``seeds``."""
    spec = fenced_spec(config)
    B, T = traffic["batch"], traffic["steps"]
    block = 512 if B % 512 == 0 else B
    samples = []
    for seed in seeds:
        state, mean = stepping_run(spec, B, T, seed, block, device,
                                   sum_dtype=sum_dtype)
        samples.append((seed, checks.state_rows(state), float(mean)))
    return check_stepping(config, traffic, samples, device)
