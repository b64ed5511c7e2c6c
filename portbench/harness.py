"""The benchmark's machinery: find a cell's configuration, traffic mix,
limits and metric readers by the names in ``BENCHMARK.json``, check the
card, time set-up and the window, read the trace, decide ``correct`` and
print the result line.

Nothing here knows a cell by name.  A cell is a ``workloads`` entry; its
configuration is the JSON file its ``configs`` entry names, its traffic mix
``portbench/traffic/<traffic>.json`` (whose ``runner`` names a module of
``portbench/runners/``), its limits ``portbench/limits/<cell>.json`` and
each of its metrics ``portbench/metrics/<metric>.py`` (a ``read(ctx)``
that returns a number, or None where it finds nothing to read).

A runner module holds all that only its kind of cell knows: ``Cell`` (set-up,
``window``, ``trace``, ``release``, ``check``), ``tiny(config, traffic,
card=False)`` (copies at the sizes the tests run), ``FAULTS`` (the faults
its stand-ins can plant), ``standin(config, traffic, seed, device, mode)``
(the reference in the program's place: the control, or a fault) and
``covers_sample(traffic)`` (whether a traced run keeps all that the check
judges); a runner whose check judges sampled answers also has ``check(config,
traffic, samples, device)``.  So a cell of a new runner is new files only."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# top-level module names that must not be loaded in a run: JAX and the
# JAX package with its drop-in (compared whole: the port's name begins with
# the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "ngx", "gym_novel_gridworlds")


class SetupError(RuntimeError):
    """The run cannot start: no card, too few cards, a file missing."""


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (``sys.modules`` by
    default), each compared whole."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN})


def load_benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise SetupError(f"{path} not found")
    return json.loads(path.read_text())


def find_cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """Everything that belongs to ``workload``, found by name: its entry,
    configuration, traffic mix, limits and metric entries (end-to-end and
    per-layer, those that list it or list no cells)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SetupError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[cell["config"]]
    pkg = Path(root) / "portbench"
    traffic_path = pkg / "traffic" / f"{cell['traffic']}.json"
    limits_path = pkg / "limits" / f"{workload}.json"
    for path in (Path(root) / config_entry["file"], traffic_path, limits_path):
        if not path.is_file():
            raise SetupError(f"{path} not found")

    def mine(entries):
        return [m for m in entries
                if workload in m.get("workloads", [workload])]

    return dict(
        cell=cell, config_entry=config_entry,
        config=json.loads((Path(root) / config_entry["file"]).read_text()),
        traffic=json.loads(traffic_path.read_text()),
        limits=json.loads(limits_path.read_text()),
        end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]))


def load_runner(traffic: dict):
    """The runner module the traffic mix names."""
    return importlib.import_module(f"portbench.runners.{traffic['runner']}")


def standin_fault(mode: str, faults):
    """The fault a stand-in's ``mode`` plants: None for ``control`` (the
    reference in the precision below the configuration's), ``mode`` itself
    where it is one of the runner's ``faults``; any other mode raises."""
    if mode == "control":
        return None
    if mode not in faults:
        raise ValueError(f"mode {mode!r} is neither 'control' nor one of "
                         f"the runner's faults {tuple(faults)}")
    return mode


def load_reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = Path(root) / "portbench" / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise SetupError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def require_cards(chips: int):
    """Raise :class:`SetupError` unless CUDA is there with ``chips`` cards:
    the benchmark never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise SetupError("torch.cuda.is_available() is false: the benchmark "
                         "measures the card and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise SetupError(f"{torch.cuda.device_count()} card(s), the cell "
                         f"asks for {chips}")


def card_power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    line = out.stdout.strip().splitlines()
    return line[0].strip() if out.returncode == 0 and line else None


def read_metrics(entries, ctx, root: Path = ROOT) -> dict:
    """``{name: {"value", "unit"}}`` of the entries whose reader found
    something to read."""
    out = {}
    for m in entries:
        value = load_reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict):
    """``(correct, checks)``: each compared number beside its limit;
    correct when every number is finite and at most its limit and every
    limit has its number."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = (value is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
