"""The readers of the program's own spans (``portbench/spans.py`` and the
metrics that use it) on synthetic traces and recorders, then on a tiny
traced cell of each kind on the CPU.

Run: ``python -m pytest portbench/tests -q`` from the root of the repo."""

import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, spans  # noqa: E402
from portbench.trace import Trace, reduce  # noqa: E402
import ngx_torch.utils  # noqa: E402
from ngx_torch.utils import trace as T  # noqa: E402

from test_portbench_mixes import SEED, tiny  # noqa: E402

BENCH = harness.load_benchmark(ROOT)
MS = 1_000_000                   # nanoseconds a millisecond
READERS = ["acting_ms.train", "recompute_ms.train", "draw_host_ms.train",
           "idle_in_update.train", "idle_in_draws.train",
           "stage_steps.chain", "stage_step_ms.chain",
           "policy_build_ms.eval", "reset_ms.eval",
           "host_reads_per_eval.eval"]
# the readers of device-timeline times: none on the CPU
DEVICE = {"acting_ms.train", "recompute_ms.train"}


def S(name, start, end, parent=None, device=None, **counts):
    """A recorded span from ``start`` to ``end`` milliseconds."""
    return T.Span(name, parent, start * MS, end * MS, counts, device)


def synthetic():
    """A traced window of 0-100 ms with the device busy at 0-10 and 50-60
    ms (idle 10-50 and 60-100), and the recorder's spans of two updates, a
    refresh and two evaluations, one span lying past the window."""
    tr = Trace([("k", 0, 10 * MS), ("k", 50 * MS, 60 * MS)], [], [], 0.1,
               0, 100 * MS)
    acting = [S("ngx_torch.train.acting", 1, 5, device=2.5),
              S("ngx_torch.train.acting", 41, 45, device=3.5)]
    d1 = S("ngx_torch.train.draw", 20, 30, acting[0])
    draws = [d1,
             # the idle gap 10-50 split across two draws: 20-30 and 30-45
             S("ngx_torch.train.draw", 30, 45, acting[1]),
             # busy 55-60, idle 60-65
             S("ngx_torch.train.draw", 55, 65, acting[1])]
    child = S("ngx_torch.test.inner", 22, 26, d1)
    updates = [S("ngx_torch.train.update", 5, 20),      # idle 10-20
               S("ngx_torch.train.update", 58, 62)]     # idle 60-62
    recompute = [S("ngx_torch.train.recompute", 3, 4, device=1.0),
                 S("ngx_torch.train.recompute", 45, 46, device=2.0)]
    refresh = S("ngx_torch.train.refresh", 0, 50)
    stages = [S("ngx_torch.chain.stage", 1, 31, refresh, steps=30),
              S("ngx_torch.chain.stage", 31, 43, refresh, steps=10)]
    runs = [S("ngx_torch.eval.run", 10, 40, steps=20, host_reads=24),
            S("ngx_torch.eval.run", 50, 90, steps=40, host_reads=44)]
    policy = [S("ngx_torch.eval.policy", 8, 9), S("ngx_torch.eval.policy",
                                                  48, 51)]
    resets = [S("ngx_torch.eval.reset", 9, 10, envs=64),
              S("ngx_torch.eval.reset", 12, 15, runs[0], envs=3),
              S("ngx_torch.eval.reset", 60, 62, runs[1], envs=5)]
    past = [S("ngx_torch.train.update", 101, 150),
            S("ngx_torch.eval.run", 99, 101, steps=7, host_reads=11)]
    return tr, (acting + draws + [child] + updates + recompute + [refresh]
                + stages + runs + policy + resets + past)


# the readings of the synthetic recorder, by hand
EXPECTED = {
    "acting_ms.train": 3.0,                      # (2.5 + 3.5) / 2
    "recompute_ms.train": 1.5,
    # self times 10 - 4, 15, 10 over two updates
    "draw_host_ms.train": (6 + 15 + 10) / 2,
    # idle 10-20 and 60-62 of 100 ms
    "idle_in_update.train": 12.0,
    # idle 20-45 and 60-65 of 100 ms
    "idle_in_draws.train": 30.0,
    "stage_steps.chain": 40.0,
    "stage_step_ms.chain": (30 + 12) / 40,
    "policy_build_ms.eval": (1 + 3) / 2,
    "reset_ms.eval": (1 + 3 + 2) / 60,
    "host_reads_per_eval.eval": 34.0,
}


def read(name, ctx):
    return harness.load_reader(name, ROOT)(ctx)


def test_the_readers_are_the_benchmarks():
    assert set(READERS) <= {m["name"] for m in BENCH["per_layer"]}
    assert set(EXPECTED) == set(READERS)


@pytest.mark.parametrize("name", READERS)
def test_no_trace_reads_nothing(name):
    assert read(name, {}) is None
    assert read(name, {"updates": 8, "episodes_traced": 64}) is None


@pytest.mark.parametrize("name", READERS)
def test_no_spans_read_nothing(name, monkeypatch):
    tr, _ = synthetic()
    monkeypatch.setattr(T, "RECORDER", T.Recorder())
    assert read(name, {"trace": tr}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_recorder_reads_nothing(name, monkeypatch):
    """The parent of the recorder has no ``ngx_torch.utils.trace``."""
    tr, recorded = synthetic()
    rec = T.Recorder()
    rec.spans = recorded
    monkeypatch.setattr(T, "RECORDER", rec)
    monkeypatch.delattr(ngx_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "ngx_torch.utils.trace", None)
    assert read(name, {"trace": tr}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_filled_recorder_reads_the_expected_number(name, monkeypatch):
    tr, recorded = synthetic()
    rec = T.Recorder()
    rec.spans = recorded
    monkeypatch.setattr(T, "RECORDER", rec)
    assert read(name, {"trace": tr}) == pytest.approx(EXPECTED[name])


def test_an_idle_gap_is_cut_by_the_spans_around_it():
    """A gap split across two spans counts once for each part, a span's
    busy part counts nothing, and a gap outside every span counts nothing:
    the device idle 10-50 and 60-100 ms of the window."""
    tr, _ = synthetic()
    assert spans.idle_gaps(tr) == [[10 * MS, 50 * MS], [60 * MS, 100 * MS]]
    within = [[20 * MS, 30 * MS], [30 * MS, 45 * MS], [55 * MS, 65 * MS]]
    assert spans.covered_ns(spans.idle_gaps(tr), within) == 30 * MS
    assert spans.covered_ns([[0, 5], [3, 9]], [[4, 6], [8, 20]]) == 3


def cpu_profile(fn):
    """``trace.profile`` on the CPU: host activity alone, no synchronize."""
    import time
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        start_ns = time.time_ns()
        result = fn()
        end_ns = time.time_ns()
        window_s = time.perf_counter() - t0
    return result, reduce(prof, window_s, start_ns, end_ns)


@pytest.mark.parametrize("workload", ["pogostick-v1-lidar.train",
                                      "chain-v2-v5.train",
                                      "pogostick-v1-lidar.eval"])
def test_a_traced_cell_reads_its_spans(workload):
    """A tiny traced run of the cell on the CPU: each new metric of the
    cell reads a finite number, but for the device's times, which a
    process without CUDA in use has not (with it, the spans' CUDA events
    read the idle stream)."""
    cell, config, traffic = tiny(workload)
    c = harness.load_runner(traffic).Cell(config, traffic, SEED,
                                          torch.device("cpu"))
    ctx = {"seconds": 0.0}
    c.trace(ctx, cpu_profile)
    mine = [m for m in cell["per_layer"] if m["name"] in READERS]
    assert mine
    for m in mine:
        value = read(m["name"], ctx)
        if m["name"] in DEVICE and not torch.cuda.is_initialized():
            assert value is None, m["name"]
        elif m["name"] in DEVICE:
            assert value is not None and value >= 0, m["name"]
        else:
            assert value is not None and math.isfinite(value), m["name"]
            assert value > 0 or m["name"].startswith("idle_in"), m["name"]
