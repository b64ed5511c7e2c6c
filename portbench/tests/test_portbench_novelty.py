"""The fence novelty's cells on the CPU at a tiny size: each runner's cell,
judged by the novelty reference (``portbench/reference/novelty.py``), reads
0 on every exact number and stays within every other limit; the program
broken underneath (an altered pool row, the plain spec in place of the
fenced one, an altered action) and the reference's planted faults each
read not correct; the frozen fence spec and pool draw equal the port's;
the pool draw's readers read their spans and trace.

Run: ``python -m pytest portbench/tests -q`` from the root of the repo."""

import copy
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.reference import checks, novelty  # noqa: E402
from portbench.trace import Trace  # noqa: E402
from ngx_torch.utils import trace as T  # noqa: E402

BENCH = harness.load_benchmark(ROOT)
CPU = torch.device("cpu")
SEED = 2 ** 31 + 22222          # past 32 signed bits, as a run's may be
TRAIN = "pogostick-v1-fence-medium.train"
STEPPING = "pogostick-v1-fence-medium.stepping"
CELLS = [TRAIN, STEPPING]
EXACT = ("trajectory_mismatch", "pool_rows_mismatch", "state_rows_mismatch")
MS = 1_000_000                  # nanoseconds a millisecond


def tiny(workload):
    """The cell at B 256, T 8 with 2 checked updates (train), or B 1,024,
    T 48 (stepping), with its own limits."""
    cell = harness.find_cell(BENCH, workload, ROOT)
    config = copy.deepcopy(cell["config"])
    traffic = dict(cell["traffic"])
    if workload == TRAIN:
        config["ppo"].update(num_envs=256, rollout_steps=8, epochs=2,
                             num_minibatches=2, episode_cap=20)
        traffic.update(fetch_every=3, checked_updates=2)
    else:
        traffic.update(batch=1024, steps=48, sample_from=4, samples=2,
                       trace_calls=4)
    return cell, config, traffic


def drive(workload, seconds=0.2):
    """Set-up, a short window and the check, as ``run.py`` drives a cell;
    returns ``(correct, numbers, ctx)``."""
    cell, config, traffic = tiny(workload)
    c = harness.load_runner(traffic).Cell(config, traffic, SEED, CPU)
    ctx = {}
    c.window(seconds, ctx)
    c.release()
    numbers = c.check()
    return harness.judge(numbers, cell["limits"])[0], numbers, ctx


@pytest.mark.parametrize("workload", CELLS)
def test_the_port_agrees_with_the_novelty_reference(workload):
    correct, numbers, ctx = drive(workload)
    assert correct, numbers
    assert all(numbers[k] == 0 for k in EXACT if k in numbers), numbers
    assert ctx["attempted"] > 0 and ctx["failed"] == 0


def test_the_train_cell_runs_in_pool_mode_and_records_its_first_pool():
    _, config, traffic = tiny(TRAIN)
    c = harness.load_runner(traffic).Cell(config, traffic, SEED, CPU)
    assert c.mode == "pool" and c.obs_dim == 72 and c.n_actions == 18
    (rows,) = c.record["pools"]
    assert rows.shape[0] == 256 * config["pool_slots"]


# ---- the program broken underneath ------------------------------------------
def _plain_spec(monkeypatch):
    import ngx_torch.novelty as N

    monkeypatch.setattr(N, "inject_novelty", lambda spec, *a, **k: spec)


def _altered_pool(monkeypatch):
    from ngx_torch.rl import train

    inner = train.pool_reset

    def altered(*args, **kwargs):
        pool = inner(*args, **kwargs)
        pool.map[0, 0] += 1
        return pool

    monkeypatch.setattr(train, "pool_reset", altered)


def _altered_action(monkeypatch):
    from ngx_torch.rl import train

    inner = train.train_rollout

    def altered(*args, **kwargs):
        out = list(inner(*args, **kwargs))
        out[2] = out[2].clone()
        out[2][0, 0] = (out[2][0, 0] + 1) % args[0].n_actions
        return tuple(out)

    monkeypatch.setattr(train, "train_rollout", altered)


@pytest.mark.parametrize("workload, fault", [
    (TRAIN, _altered_pool), (TRAIN, _plain_spec), (TRAIN, _altered_action),
    (STEPPING, _plain_spec)], ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_program_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    correct, numbers, _ = drive(workload)
    assert not correct, numbers


@pytest.mark.parametrize("fault", novelty.FAULTS)
def test_a_planted_fault_is_not_correct(fault):
    cell, config, traffic = tiny(TRAIN)
    numbers = novelty.standin_train(config, traffic, SEED, CPU, fault=fault)
    assert not harness.judge(numbers, cell["limits"])[0], numbers
    if fault == "pool":
        assert numbers["pool_rows_mismatch"] == 1, numbers


def test_nothing_to_judge_is_not_correct():
    cell, config, traffic = tiny(STEPPING)
    numbers = novelty.check_stepping(config, traffic, [], CPU)
    assert not harness.judge(numbers, cell["limits"])[0], numbers


# ---- the frozen copies against the port -------------------------------------
def _spec_pair(config):
    import ngx_torch as nt
    from ngx_torch.transforms import lidar_in_front

    port = lidar_in_front(nt.inject_novelty(nt.make_spec(config["env_id"]),
                                            *config["novelty"]))
    return port, novelty.fenced_spec(config)


@pytest.mark.parametrize("difficulty", ["easy", "medium", "hard"])
def test_the_frozen_fence_spec_is_the_ports(difficulty):
    config = dict(tiny(TRAIN)[1], novelty=["fence", difficulty, "oak"])
    port, frozen = _spec_pair(config)
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [f.name for f in dataclasses.fields(frozen)]
    for name in names:
        a, b = getattr(port, name), getattr(frozen, name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert np.asarray(a).dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert port.key == frozen.key
    assert frozen.reset_edits[-1][0] == "fence"


def test_the_frozen_copy_holds_the_fence_alone():
    config = dict(tiny(TRAIN)[1], novelty=["firewall", "easy", ""])
    with pytest.raises(ValueError):
        novelty.fenced_spec(config)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 2])
def test_the_frozen_pool_draw_is_the_ports(seed):
    from ngx_torch.ops.rollout import pool_reset

    config = tiny(TRAIN)[1]
    port, frozen = _spec_pair(config)
    n = 512 * config["pool_slots"]
    want = checks.state_rows(novelty.draw_pool(frozen, n, seed, CPU))
    got = checks.state_rows(pool_reset(port, n, seed, device=CPU))
    assert got.shape == want.shape and torch.equal(got, want)
    # the fence fills 50-90% of the items' cells: the maps hold fence
    assert (novelty.draw_pool(frozen, 64, seed, CPU).map == 9).any()


# ---- the pool draw's readers ------------------------------------------------
def _read(name, ctx):
    return harness.load_reader(name, ROOT)(ctx)


def _recorder(monkeypatch, spans):
    rec = T.Recorder()
    rec.spans = spans
    monkeypatch.setattr(T, "RECORDER", rec)


def test_the_host_reader_reads_its_spans(monkeypatch):
    tr = Trace([], [], [], 0.1, 0, 100 * MS)
    pool = [T.Span("ngx_torch.train.pool", None, 0, 10 * MS),
            T.Span("ngx_torch.train.pool", None, 50 * MS, 60 * MS)]
    draws = [T.Span("ngx_torch.train.pool_draw", pool[0], 1 * MS, 3 * MS,
                    {"rows": 1024, "edits": 1}),
             T.Span("ngx_torch.train.pool_draw", pool[1], 51 * MS, 55 * MS,
                    {"rows": 1024, "edits": 1})]
    updates = [T.Span("ngx_torch.train.update", None, 20 * MS, 40 * MS),
               T.Span("ngx_torch.train.update", None, 70 * MS, 90 * MS)]
    _recorder(monkeypatch, pool + draws + updates)
    assert _read("pool_draw_host_ms.train", {"trace": tr}) == \
        pytest.approx((2 + 4) / 2)
    # a span without ``rows``, or none at all (the parent): nothing
    for d in draws:
        d.counts = {}
    assert _read("pool_draw_host_ms.train", {"trace": tr}) is None
    _recorder(monkeypatch, updates)
    assert _read("pool_draw_host_ms.train", {"trace": tr}) is None
    assert _read("pool_draw_host_ms.train", {}) is None


def test_the_roofline_reader_reads_the_stepping_kernel_alone():
    kernels = [("void rollout_kernel<true, 0, signed char>(Args, Hdr)",
                0, 2 * MS // 10),
               ("void rollout_kernel<true, 0, signed char>(Args, Hdr)",
                MS, MS + 3 * MS // 10),
               ("void train_rollout_kernel<true, signed char>(Args)",
                2 * MS, 3 * MS),
               ("void policy_rollout_kernel<true, signed char>(Args)",
                4 * MS, 9 * MS)]
    tr = Trace(kernels, [], [], 0.01, 0, 10 * MS)
    ctx = {"trace": tr, "pool_draw_bound_ms": 0.005}
    # 0.005 ms over the two launches' mean, 0.25 ms
    assert _read("pool_draw_roofline.train", ctx) == pytest.approx(2.0)
    assert _read("pool_draw_roofline.train", {"trace": tr}) is None
    ctx["trace"] = Trace(kernels[2:], [], [], 0.01, 0, 10 * MS)
    assert _read("pool_draw_roofline.train", ctx) is None


def test_a_traced_train_cell_reads_its_pool_draws():
    """A tiny traced run on the CPU: one pool-draw span an update, read as
    a finite host time; the kernel's roofline needs the device."""
    from test_portbench_spans import cpu_profile

    cell, config, traffic = tiny(TRAIN)
    c = harness.load_runner(traffic).Cell(config, traffic, SEED, CPU)
    ctx = {"seconds": 0.0}
    c.trace(ctx, cpu_profile)
    draws = [s for s in T.spans() if s.name == "ngx_torch.train.pool_draw"]
    assert len(draws) == traffic["fetch_every"]
    assert all(s.counts == {"rows": 256 * 4, "edits": 1} for s in draws)
    value = _read("pool_draw_host_ms.train", ctx)
    assert value is not None and math.isfinite(value) and value > 0
    assert ctx["pool_draw_bound_ms"] > 0
    names = {m["name"] for m in cell["per_layer"]}
    assert {"pool_draw_host_ms.train", "pool_draw_roofline.train"} <= names
