"""The port's multi-device layer (ngx_torch/parallel) on the CPU: the
sharded VecEnv, the sharded env-stepping rollouts against their in-process
twin, the counted collectives, torchrun-style start-up and the scaling
harness.

Rank processes are started one run at a time by spawn_ranks with gloo,
one torch thread each and a time limit of their own, so a hung rank fails
the test instead of eating the suite's clock.  No test here asserts a
timing ratio."""

import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_ranks as R
from ngx.parallel import episode_metrics as ngx_episode_metrics
from ngx.vector import Trajectory as NgxTrajectory
from ngx_torch import parallel as P
from ngx_torch.ops import rollout as RO
from ngx_torch.ops.tables import seed_i32
from ngx_torch.rl.train import dryrun
from ngx_torch.vector import Trajectory, VecEnv, throughput_fn

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

SPAWN_TIMEOUT = 240.0


def _cat_states(states):
    return {k: np.concatenate([s[k] for s in states])
            for k in states[0]}


def _assert_state_equal(got: dict, want):
    want = want.to_numpy() if hasattr(want, "to_numpy") else want
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("W", [2, 4])
def test_sharded_vec_matches_unsharded(W):
    """make_sharded_vec at W 2 and 4 (counterpart of
    tests/test_vector.py:141): every rank's reset and steps — random
    actions through rollout, then input actions through step, with cap
    resets — concatenated over the ranks equal the unsharded VecEnv's bit
    for bit, on a spec with a reset edit (the v3 wall coin)."""
    spec = R.spec_of("NovelGridworld-v3")
    B, T, cap, seed = 256, 6, 3, 11
    full = VecEnv(spec, episode_cap=cap, reset_obs=True)
    state, obs = full.reset(seed, B, device="cpu")
    state, traj = full.rollout(state, seed, None, T)
    acts = torch.as_tensor(np.random.RandomState(0).randint(
        spec.n_actions, size=B))
    state2, obs2, rew2, done2, _ = full.step(state, acts, seed, T + 1)
    assert int(traj.dones.sum()) > 0          # resets on the path
    shards = []
    for mesh in P.make_local_meshes(W, "cpu"):
        vec = P.make_sharded_vec(spec, mesh, episode_cap=cap, reset_obs=True)
        st, ob = vec.reset(seed, B)
        assert st.batch == B // W and st.device.type == "cpu"
        lo, hi = mesh.rows(B)
        assert torch.equal(ob, obs[lo:hi])
        st, tr = vec.rollout(st, seed, None, T)
        st2, ob2, r2, d2, _ = vec.step(st, acts[lo:hi], seed, T + 1)
        for got, want in ((tr.obs, traj.obs[:, lo:hi]),
                          (tr.actions, traj.actions[:, lo:hi]),
                          (tr.rewards, traj.rewards[:, lo:hi]),
                          (tr.dones, traj.dones[:, lo:hi]),
                          (ob2, obs2[lo:hi]), (r2, rew2[lo:hi]),
                          (d2, done2[lo:hi])):
            assert torch.equal(got, want)
        shards.append(st2.to_numpy())
    _assert_state_equal(_cat_states(shards), state2)


def test_host_local_keys_are_the_global_streams():
    from ngx_torch.ops.rng import block_streams

    seeds, rows = block_streams(5, 512, 512)
    for mesh in P.make_local_meshes(4, "cpu"):
        keys = P.host_local_keys(5, 512, mesh)
        assert (keys.lo, keys.hi) == (128 * mesh.rank, 128 * (mesh.rank + 1))
        assert torch.equal(keys.seeds, seeds[keys.lo:keys.hi])
        assert torch.equal(keys.rows, rows[keys.lo:keys.hi])
    with pytest.raises(ValueError, match="does not split"):
        P.make_local_meshes(3, "cpu")[0].rows(512)


def test_shard_seed_wraps_as_int32():
    """ngx adds rank * int32(612331) to an int32 seed, which wraps; Python
    ints do not, so shard_seed wraps by hand."""
    top = 2 ** 31 - 1000
    got = P.shard_seed(top, 3)
    want = int(jnp.int32(top) + jnp.int32(3) * jnp.int32(612331))
    assert got == want and got < 0
    assert P.shard_seed(77, 0) == 77


def test_episode_metrics_all_reduce_once():
    """episode_metrics over two in-process ranks: one all-reduce each, and
    ngx's global values of the whole trajectory."""
    rng = np.random.RandomState(2)
    T, B = 8, 64
    rew = rng.randn(T, B).astype(np.float32)
    done = rng.rand(T, B) < 0.1
    cost = rng.rand(T, B).astype(np.float32)
    want = ngx_episode_metrics(NgxTrajectory(
        None, None, jnp.asarray(rew), jnp.asarray(done), jnp.asarray(cost)))
    out = [None, None]
    meshes = P.make_local_meshes(2, "cpu")

    def rank(mesh):
        lo, hi = mesh.rows(B)
        out[mesh.rank] = P.episode_metrics(Trajectory(
            None, None, torch.as_tensor(rew[:, lo:hi]),
            torch.as_tensor(done[:, lo:hi]), torch.as_tensor(cost[:, lo:hi])),
            mesh)

    threads = [threading.Thread(target=rank, args=(m,)) for m in meshes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for m in meshes:
        assert m.log == [("all_reduce", "metrics", 32)]
    for got in out:
        assert sorted(got) == sorted(want)
        assert int(got["episodes_finished"]) == int(want["episodes_finished"])
        assert int(got["steps"]) == int(want["steps"]) == T * B
        for k in ("mean_reward", "mean_step_cost"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-6, err_msg=k)


def test_sharded_stepping_matches_in_process_twin():
    """sharded_throughput_fn and make_spmd_rollout (plain and packed) at W 2
    on spawned gloo ranks (counterparts of tests/test_distributed.py:239
    and tests/test_vector.py:168-195): each rank's final state equals its
    rows of the unsharded throughput_fn's (the rank's seed is its first
    block's stream), the global mean and episode count equal the twin's —
    each shard through the 'prng' twin, the float32 shard sums added in
    rank order — packed equals plain, and the only collectives are one
    metrics all-reduce of 16 bytes a call."""
    spec_name, B, T, seed = "NovelGridworld-v3", 1024, 16, 9
    spec = R.spec_of(spec_name)
    res = P.spawn_ranks(R.stepping_rank, 2, (spec_name, B, T, seed),
                        device="cpu", timeout=SPAWN_TIMEOUT)
    full, _ = throughput_fn(spec, B, T, device="cpu")(seed)
    _assert_state_equal(_cat_states([r["state"] for r in res]), full)
    sums = []
    for k in range(2):
        shard = RO.rollout(spec, 512, T, seed_i32(seed + k * 7919), 512,
                           "prng", device="cpu")
        sums.append((float(shard[1].sum()), int(shard[2].sum())))
    mean = np.float32((sums[0][0] + sums[1][0]) / (B * T))
    episodes = sums[0][1] + sums[1][1]
    assert episodes > 0
    for r in res:
        assert float(r["mean"]) == mean and int(r["episodes"]) == episodes
        for key in ("plain", "packed"):
            assert float(r[key][0]) == mean and int(r[key][1]) == episodes
        assert r["collectives"] == [("all_reduce", "metrics", 16)] * 3


def test_initialize_distributed_from_torchrun_env():
    """Under torchrun, initialize_distributed with no arguments reads its
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, picks gloo for the CPU,
    and the mesh it makes sums over both ranks."""
    argv = [sys.executable, "-m", "torch.distributed.run",
            "--nproc_per_node", "2", "--master_addr", "localhost",
            "--master_port", str(P._free_port()), R.__file__]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(R.__file__)),
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                          timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # the two ranks share one stdout, so their lines may run together
    res = sorted((json.loads(m) for m in
                  re.findall(r"RESULT (\{[^{}]*\})", proc.stdout)),
                 key=lambda r: r["rank"])
    assert [(r["rank"], r["size"], r["backend"], r["sum"]) for r in res] == \
        [(0, 2, "gloo", 3.0), (1, 2, "gloo", 3.0)]


def test_backends_are_asked_for_never_switched():
    """NCCL names the card and raises for the CPU; no coordinator and no
    torchrun variables raise; a mesh of more devices than processes
    raises; the default mesh is rank 0 of 1, whose collectives are the
    identity and still counted; without a card the mesh, spawn_ranks and
    dryrun, which default to it, raise."""
    assert P.pick_backend("cpu") == "gloo"
    assert P.pick_backend("cpu", "gloo") == "gloo"
    with pytest.raises(ValueError, match="NCCL"):
        P.pick_backend("cpu", "nccl")
    with pytest.raises(ValueError, match="backend"):
        P.pick_backend("cpu", "mpi")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        P.initialize_distributed(device="cpu")
    with pytest.raises(ValueError, match="one process per"):
        P.make_env_mesh(2, device="cpu")
    mesh = P.make_env_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    t = torch.ones(3)
    assert torch.equal(mesh.all_reduce(t, "x"), torch.ones(3))
    assert mesh.log == [("all_reduce", "x", 12)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.make_env_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.spawn_ranks(R.fail_rank, 1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun(1)


def test_spawn_ranks_reports_failures_and_time_limits():
    """A rank that raises ends the run with its traceback; a rank that
    hangs ends it at the time limit; both stop every process."""
    with pytest.raises(RuntimeError, match="rank 0 of 1 failed"):
        P.spawn_ranks(R.fail_rank, 1, device="cpu", timeout=SPAWN_TIMEOUT)
    with pytest.raises(TimeoutError, match="no result from ranks"):
        P.spawn_ranks(R.hang_rank, 1, device="cpu", timeout=8.0)


def test_measure_scaling_returns_ngx_keys():
    """The scaling harness with one process per rank returns ngx's record
    (ngx/rl/scaling.py:47-79) in both modes; it asserts no ratio."""
    from ngx_torch.rl.scaling import measure_scaling

    for mode, counts in (("fixed-total", (1, 2)), ("weak", (1,))):
        r = measure_scaling(counts, per_device_batch=128, rollout_steps=4,
                            repeats=1, mode=mode, hidden=(16, 16),
                            device="cpu", timeout=SPAWN_TIMEOUT)
        assert sorted(r) == ["efficiency", "mode", "per_device_batch",
                             "rollout_steps", "throughput"]
        assert r["mode"] == mode and tuple(r["throughput"]) == counts
        assert all(v > 0 for v in r["throughput"].values())
        assert r["efficiency"][1] == 1.0
    with pytest.raises(ValueError, match="mode"):
        measure_scaling((1,), mode="strong", device="cpu")
