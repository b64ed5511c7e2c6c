"""The reader of ``draw_kernel_share.eval``
(``portbench/metrics/draw_kernel_share.eval.py``) on synthetic recorders:
evaluation spans with and without ``kernel_draws``, and none at all; then
on a tiny traced eval cell on the CPU, where the plain draw runs and the
share reads 0.

Run: ``python -m pytest portbench/tests -q`` from the root of the repo."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import ngx_torch.utils  # noqa: E402
from portbench import harness  # noqa: E402

from test_portbench_mixes import SEED, tiny  # noqa: E402
from test_portbench_reset_share import recorder  # noqa: E402
from test_portbench_spans import S, cpu_profile, synthetic  # noqa: E402

NAME = "draw_kernel_share.eval"


def read(ctx):
    return harness.load_reader(NAME, ROOT)(ctx)


def test_the_reader_is_the_benchmarks():
    (m,) = [m for m in harness.load_benchmark(ROOT)["per_layer"]
            if m["name"] == NAME]
    assert (m["unit"], m["better"], m["moves"], m["source"]) == (
        "%", "higher", "eval_episodes_per_s", "program_counter")
    (reset,) = [m for m in harness.load_benchmark(ROOT)["per_layer"]
                if m["name"] == "reset_kernel_share.eval"]
    assert (m["layer"], m["workloads"]) == (reset["layer"],
                                            reset["workloads"])


@pytest.mark.parametrize("kernel_draws,share", [
    ((None, None, None), 0.0),        # the plain draw: no kernel_draws
    ((20, None, 7), 100.0 * 27 / 40),
    ((20, 13, 7), 100.0)])
def test_the_share_reads_the_kernel_draws(monkeypatch, kernel_draws, share):
    """Three evaluation spans of 20, 13 and 7 steps inside the window (and
    one past it, which counts nothing)."""
    tr, _ = synthetic()
    spans = []
    for (a, b, steps), k in zip([(9, 10, 20), (12, 15, 13), (60, 62, 7)],
                                kernel_draws):
        counts = {"steps": steps, "host_reads": steps + 4}
        if k is not None:
            counts["kernel_draws"] = k
        spans.append(S("ngx_torch.eval.run", a, b, **counts))
    spans.append(S("ngx_torch.eval.run", 101, 102, steps=9, kernel_draws=9))
    recorder(monkeypatch, spans)
    assert read({"trace": tr}) == pytest.approx(share)


def test_no_evaluation_reads_nothing(monkeypatch):
    tr, _ = synthetic()
    assert read({}) is None
    recorder(monkeypatch, [])
    assert read({"trace": tr}) is None
    recorder(monkeypatch, [S("ngx_torch.eval.reset", 10, 40, envs=64,
                             kernel_envs=64)])
    assert read({"trace": tr}) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    tr, recorded = synthetic()
    recorder(monkeypatch, recorded)
    monkeypatch.delattr(ngx_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "ngx_torch.utils.trace", None)
    assert read({"trace": tr}) is None


def test_a_traced_cpu_cell_reads_0():
    """The tiny eval cell traced on the CPU: every draw is the plain
    twin's, so the share reads 0."""
    _, config, traffic = tiny("pogostick-v1-lidar.eval")
    c = harness.load_runner(traffic).Cell(config, traffic, SEED,
                                          torch.device("cpu"))
    ctx = {"seconds": 0.0}
    c.trace(ctx, cpu_profile)
    assert read(ctx) == 0.0
