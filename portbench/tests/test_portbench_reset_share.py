"""The reader of ``reset_kernel_share.eval``
(``portbench/metrics/reset_kernel_share.eval.py``) on synthetic recorders:
reset spans with and without ``kernel_envs``, and none at all; then on a
tiny traced eval cell on the CPU, where the plain reset runs and the share
reads 0.

Run: ``python -m pytest portbench/tests -q`` from the root of the repo."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import ngx_torch.utils  # noqa: E402
from ngx_torch.utils import trace as T  # noqa: E402
from portbench import harness  # noqa: E402

from test_portbench_mixes import SEED, tiny  # noqa: E402
from test_portbench_spans import S, cpu_profile, synthetic  # noqa: E402

NAME = "reset_kernel_share.eval"


def read(ctx):
    return harness.load_reader(NAME, ROOT)(ctx)


def recorder(monkeypatch, spans):
    rec = T.Recorder()
    rec.spans = spans
    monkeypatch.setattr(T, "RECORDER", rec)


def test_the_reader_is_the_benchmarks():
    (m,) = [m for m in harness.load_benchmark(ROOT)["per_layer"]
            if m["name"] == NAME]
    assert (m["unit"], m["better"], m["moves"]) == (
        "%", "higher", "eval_episodes_per_s")


@pytest.mark.parametrize("kernel_envs,share", [
    ((None, None, None), 0.0),        # the plain reset: no kernel_envs
    ((64, None, 5), 100.0 * 69 / 72),
    ((64, 3, 5), 100.0)])
def test_the_share_reads_the_kernel_envs(monkeypatch, kernel_envs, share):
    """Three reset spans of 64, 3 and 5 rows inside the window (and one
    past it, which counts nothing)."""
    tr, _ = synthetic()
    spans = []
    for (a, b, envs), k in zip([(9, 10, 64), (12, 15, 3), (60, 62, 5)],
                               kernel_envs):
        counts = {"envs": envs}
        if k is not None:
            counts["kernel_envs"] = k
        spans.append(S("ngx_torch.eval.reset", a, b, **counts))
    spans.append(S("ngx_torch.eval.reset", 101, 102, envs=9))
    recorder(monkeypatch, spans)
    assert read({"trace": tr}) == pytest.approx(share)


def test_no_reset_reads_nothing(monkeypatch):
    tr, _ = synthetic()
    assert read({}) is None
    recorder(monkeypatch, [])
    assert read({"trace": tr}) is None
    recorder(monkeypatch, [S("ngx_torch.eval.run", 10, 40, steps=20,
                             host_reads=24)])
    assert read({"trace": tr}) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    tr, recorded = synthetic()
    recorder(monkeypatch, recorded)
    monkeypatch.delattr(ngx_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "ngx_torch.utils.trace", None)
    assert read({"trace": tr}) is None


def test_a_traced_cpu_cell_reads_0():
    """The tiny eval cell traced on the CPU: every reset is the plain
    twin's, so the share reads 0 where it reads at all."""
    _, config, traffic = tiny("pogostick-v1-lidar.eval")
    c = harness.load_runner(traffic).Cell(config, traffic, SEED,
                                          torch.device("cpu"))
    ctx = {"seconds": 0.0}
    c.trace(ctx, cpu_profile)
    assert read(ctx) == 0.0
