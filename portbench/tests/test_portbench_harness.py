"""The harness's machinery on the CPU: cells, mixes and metrics found by
name, a file dropped into a copy found without an edit, the import check,
the reference's independence from the program, the refusal to measure
without a card, and the yardstick's arithmetic.

Run: ``python -m pytest portbench/tests -q`` from the root of the repo."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, yardstick  # noqa: E402

BENCH = harness.load_benchmark(ROOT)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(workload):
    cell = harness.find_cell(BENCH, workload, ROOT)
    assert cell["limits"], "a cell compares at least one number"
    harness.load_runner(cell["traffic"])
    names = [m["name"] for m in cell["end_to_end"] + cell["per_layer"]]
    assert "setup_s" in names
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    for name in names:
        assert callable(harness.load_reader(name, ROOT))


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench" / "traffic").glob("*.json")), ids=lambda p: p.stem)
def test_a_traced_run_covers_the_sample(path):
    traffic = json.loads(path.read_text())
    assert harness.load_runner(traffic).covers_sample(traffic)
    assert traffic.get("samples", 1) >= 1


def test_a_dropped_file_is_found_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [{
        "name": "pogostick-v1-lidar.stepping-8k",
        "config": "pogostick-v1-lidar", "traffic": "stepping-8k",
        "chips": 1, "why": "a dropped cell"}]
    bench["per_layer"] = BENCH["per_layer"] + [{
        "name": "calls.stepping", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "stepping_env_steps_per_s",
        "workloads": ["pogostick-v1-lidar.stepping-8k"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((ROOT / "portbench/traffic/stepping.json")
                         .read_text())
    traffic["batch"] = 8192
    (tmp_path / "portbench/traffic/stepping-8k.json").write_text(
        json.dumps(traffic))
    shutil.copy(ROOT / "portbench/limits/pogostick-v1-lidar.stepping.json",
                tmp_path / "portbench/limits/"
                "pogostick-v1-lidar.stepping-8k.json")
    (tmp_path / "portbench/metrics/calls.stepping.py").write_text(
        "def read(ctx):\n    return ctx.get('calls')\n")
    cell = harness.find_cell(bench, "pogostick-v1-lidar.stepping-8k",
                             tmp_path)
    assert cell["traffic"]["batch"] == 8192
    assert [m["name"] for m in cell["per_layer"]] == ["calls.stepping"]
    out = harness.read_metrics(cell["per_layer"], {"calls": 7}, tmp_path)
    assert out == {"calls.stepping": {"value": 7.0, "unit": "calls"}}
    assert harness.read_metrics(cell["per_layer"], {}, tmp_path) == {}


# a runner dropped into a copy: the stepping mix under another name, with
# sizes and a stand-in of its own
DROPPED_RUNNER = '''"""The stepping mix under another name."""
from portbench.runners import stepping as base
from portbench.runners.stepping import FAULTS, Cell, check, covers_sample

STANDINS = []                   # the modes asked of this module's stand-in


def tiny(config, traffic, card=False):
    config, traffic = base.tiny(config, traffic, card)
    if not card:
        traffic.update(batch=512, steps=32)
    return config, traffic


def standin(config, traffic, seed, device, mode):
    STANDINS.append(mode)
    return base.standin(config, traffic, seed, device, mode)
'''

# run in the copy: the mixes tests and calibrate.py on the dropped cell
DROPPED_DRIVE = '''
import sys
from pathlib import Path

import torch

sys.path[:0] = [".", "portbench/tests"]
import test_portbench_harness as harness_tests
import test_portbench_mixes as mixes
from portbench import calibrate
from portbench.runners import dropped

NAME, CPU = "pogostick-v1-lidar.dropped", torch.device("cpu")
harness_tests.test_every_cell_is_found_by_name(NAME)
harness_tests.test_a_traced_run_covers_the_sample(
    Path("portbench/traffic/dropped.json"))
cell, config, traffic = mixes.tiny(NAME)
assert (traffic["batch"], traffic["steps"]) == (512, 32), traffic
mixes.test_the_port_agrees_with_the_reference(NAME)
mixes.test_a_window_too_short_still_judges_its_whole_sample(NAME)
if torch.cuda.is_available():
    mixes.test_the_control_is_not_correct(NAME)
    dropped.STANDINS.clear()
got = calibrate.readings(config, traffic, mixes.SEED, "control", CPU, 0.0)
assert dropped.STANDINS == ["control"], dropped.STANDINS
assert got == dropped.standin(config, traffic, mixes.SEED, CPU, "control")
program = calibrate.readings(config, traffic, mixes.SEED, "program", CPU, 0.0)
assert mixes.harness.judge(program, cell["limits"])[0], program
print("dropped cell ok")
'''


def test_a_dropped_runner_is_found_sized_driven_and_judged(tmp_path):
    """A cell of a new runner is new files only: the runner module, its
    traffic, its limits and its ``BENCHMARK.json`` entry, dropped into a
    copy, are found, sized, driven and judged by the mixes tests, and
    calibrate.py reaches its stand-in through ``standin``, with no file of
    the copy edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    (tmp_path / "ngx_torch").symlink_to(ROOT / "ngx_torch")
    name = "pogostick-v1-lidar.dropped"
    bench = dict(BENCH, workloads=BENCH["workloads"] + [{
        "name": name, "config": "pogostick-v1-lidar", "traffic": "dropped",
        "chips": 1, "why": "a dropped runner"}])
    # the dropped cell reports what the stepping cell does
    for kind in ("end_to_end", "per_layer"):
        bench[kind] = [
            dict(m, workloads=m["workloads"] + [name])
            if "pogostick-v1-lidar.stepping" in m.get("workloads", [])
            else m for m in BENCH[kind]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pkg = tmp_path / "portbench"
    (pkg / "runners/dropped.py").write_text(DROPPED_RUNNER)
    traffic = json.loads((pkg / "traffic/stepping.json").read_text())
    (pkg / "traffic/dropped.json").write_text(
        json.dumps(dict(traffic, runner="dropped")))
    shutil.copy(pkg / "limits/pogostick-v1-lidar.stepping.json",
                pkg / f"limits/{name}.json")
    res = subprocess.run([sys.executable, "-c", DROPPED_DRIVE],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "dropped cell ok" in res.stdout
    after = {p: p.read_bytes() for p in before}
    assert after == before, "a file of the copy was edited"


@pytest.mark.parametrize("names, bad", [
    (["ngx_torch", "ngx_torch.rl.train", "numpy"], []),
    (["ngx", "ngx_torch"], ["ngx"]),
    (["ngx.core.step"], ["ngx"]),
    (["jax._src.core", "jaxlib"], ["jax", "jaxlib"]),
    (["gym_novel_gridworlds.envs", "flax.linen"],
     ["flax", "gym_novel_gridworlds"]),
    (["ngxx", "jax_like", "portbench.reference"], []),
])
def test_the_import_check_compares_top_level_names_whole(names, bad):
    assert harness.forbidden_modules(names) == bad


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench/reference").rglob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"ngx_torch", "ngx", "jax", "jaxlib", "flax",
                       "gym_novel_gridworlds", "portbench"}, tops


def test_the_benchmark_imports_no_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops)


def test_the_measuring_path_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from portbench import run

    rc = run.main(["--workload", "pogostick-v1-lidar.train", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
    assert "is_available() is false" in out.err


def test_a_checkout_of_the_benchmark_alone_refuses(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "pogostick-v1-lidar.stepping", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0 and res.stdout == ""


def test_the_bound_is_chip_smokes():
    # the native train kernel at B 8,192, T 64 on Pogostick-v1's tower
    ms, by = yardstick.kernel_bound_ms(10, 9, [63, 64, 64, 17], 8192, 64,
                                       "train")
    assert by == "operations" and round(ms, 4) == 0.1442
    # 'prng' at B 65,536, T 1,024
    ms, by = yardstick.kernel_bound_ms(10, 9, [], 65536, 1024, "prng")
    assert by == "bytes" and round(ms, 4) == 0.0094


def test_the_update_count():
    pi, v = [63, 64, 64, 17], [63, 64, 64, 1]
    assert yardstick.forward_ops(pi) == 2 * (63 * 64 + 64 * 64 + 64 * 17)
    assert yardstick.train_ops(v) == 3 * yardstick.forward_ops(v) - 2 * 63 * 64
    ops = yardstick.update_ops(63, (64, 64), 17, 8192, 64, 4, 8)
    n = 8192 * 64
    assert ops == (n * 18432 + 8192 * 65 * 16384
                   + 4 * n * (yardstick.train_ops(pi) + yardstick.train_ops(v)))


def test_judge_needs_every_number_under_its_limit():
    ok, checks = harness.judge({"a": 0.0, "b": 0.5}, {"a": 0.0, "b": 1.0})
    assert ok and checks["b"] == {"value": 0.5, "limit": 1.0}
    assert not harness.judge({"a": 0.1}, {"a": 0.0})[0]
    assert not harness.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not harness.judge({}, {"a": 1.0})[0]
