"""Rank functions for the port's multi-process tests
(tests/test_torch_parallel.py, tests/test_torch_distributed_train.py).

They run in processes started by ngx_torch.parallel.spawn_ranks, so this
module imports torch and the port only — never jax — and each rank returns
numpy (spawn_ranks converts tensors)."""

import json
import time

import torch
import torch.distributed as dist

import ngx_torch as nt
from ngx_torch import parallel as P
from ngx_torch.ops import threefry as TF
from ngx_torch.rl import train as Tt

POGO = "NovelGridworld-Pogostick-v1"
FENCE = ("fence", "medium", "oak")


def spec_of(name):
    if name == "fence":
        return nt.inject_novelty(nt.make_spec(POGO), *FENCE)
    return nt.make_spec(name)


def stepping_rank(mesh, spec_name, batch, steps, seed):
    """sharded_throughput_fn, then make_spmd_rollout plain and packed."""
    spec = spec_of(spec_name)
    state, mean, episodes = P.sharded_throughput_fn(spec, mesh, batch,
                                                    steps)(seed)
    plain = P.make_spmd_rollout(spec, mesh, batch, steps)(seed)
    packed = P.make_spmd_rollout(spec, mesh, batch, steps, packed=True)(seed)
    return {"state": state, "mean": mean, "episodes": episodes,
            "plain": plain, "packed": packed,
            "collectives": list(mesh.log)}


def torchrun_env_rank():
    """initialize_distributed from torchrun's variables alone, then one
    all-reduce over the mesh it makes."""
    backend = P.initialize_distributed(device="cpu")
    try:
        mesh = P.make_env_mesh(device="cpu")
        t = mesh.all_reduce(torch.tensor([float(mesh.rank + 1)]), "check")
        return {"rank": mesh.rank, "size": mesh.size, "sum": float(t[0]),
                "backend": backend}
    finally:
        dist.destroy_process_group()


def train_rank(mesh, case):
    """One sharded train step on ngx's keys (``case``: the config, the
    spec, and where given ngx's flax parameters and the BC data), with the
    acting kernel's twin on the CPU: the keyed init on ``key(0)`` (the
    rank's rows of ngx's init; ngx's parameters loaded over it where
    given, so both runs update the same weights), then the step on
    ``key(1)``.  Returns the init's state and the step's draws with its
    results."""
    cfg = Tt.PPOConfig(**case["cfg"])
    init, step = Tt.make_train(cfg, mesh, spec_override=spec_of(case["spec"]),
                               rollout_backend=case.get("backend", "pallas"),
                               bc_data=case.get("bc"))
    ts, state, obs, ep_ret = init(TF.key(0))
    init_state = state.to_numpy()
    if "params" in case:
        ts.model.load_flax_params(case["params"])
        ts = Tt.TrainState(ts.model, torch.optim.Adam(
            ts.model.parameters(), lr=cfg.lr, eps=1e-5))
    step.keep_rollout = True
    mesh.log.clear()
    (ts, state, last_obs, ep_ret), metrics = step(
        (ts, state, obs, ep_ret), TF.key(1))
    return {"init_state": init_state, "init_obs": obs,
            "seeds": step.seeds, "perms": step.perms,
            "state": state, "last_obs": last_obs, "ep_ret": ep_ret,
            "rollout": step.rollout,
            "params": {n: (lin.weight, lin.bias)
                       for n, lin in ts.model.named_children()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "collectives": list(mesh.log),
            "backend": step.rollout_backend, "source": step.reset_source}


def fail_rank(mesh):
    raise ValueError(f"rank {mesh.rank} fails on purpose")


def hang_rank(mesh):
    time.sleep(3600)


if __name__ == "__main__":
    # run by torchrun (tests/test_torch_parallel.py)
    print("RESULT " + json.dumps(torchrun_env_rank()), flush=True)
