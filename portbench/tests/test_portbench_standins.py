"""Each runner's stand-ins on the CPU at the tests' sizes: ``standin``
returns, bit for bit, what the reference's stand-in functions give when
called as the calibration called them for the cell (``checks`` for the
plain cells, ``novelty`` for the fence cells), in every mode the cell has;
and a mode the runner does not have raises rather than reading as a sound
run.

Run: ``python -m pytest portbench/tests -q`` from the root of the repo."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.reference import checks, novelty  # noqa: E402
from portbench.runners.eval import schedule as eval_schedule  # noqa: E402
from portbench.runners.stepping import schedule  # noqa: E402

from test_portbench_mixes import BENCH, CPU, SEED, tiny  # noqa: E402


def train(config, traffic, seed, device, mode):
    return checks.standin_train(config, traffic, seed, device,
                                tf32=mode == "control",
                                fault=None if mode == "control" else mode,
                                root=str(ROOT))


def novelty_train(config, traffic, seed, device, mode):
    return novelty.standin_train(config, traffic, seed, device,
                                 tf32=mode == "control",
                                 fault=None if mode == "control" else mode)


def stepping(reference):
    def standin(config, traffic, seed, device, mode):
        seed_of, sampled = schedule(traffic, seed)
        return reference.standin_stepping(config, traffic,
                                          [seed_of(i) for i in sampled],
                                          device, torch.bfloat16)
    return standin


def evaluate(config, traffic, seed, device, mode):
    _, sampled = eval_schedule(traffic, seed)
    return checks.standin_eval(
        config, traffic, [(int(traffic["pool_seed"]), j + 1)
                          for j in sampled], device, root=str(ROOT))


TRAIN_MODES = ("control", "half", "alter", "unchanged")
# (cell, mode, the stand-in as the calibration called it): the cells and
# modes the runners took over from the two calibration scripts
CASES = ([("pogostick-v1-lidar.train", m, train) for m in TRAIN_MODES]
         + [("chain-v2-v5.train", m, train) for m in TRAIN_MODES]
         + [("pogostick-v1-fence-medium.train", m, novelty_train)
            for m in TRAIN_MODES + ("pool",)]
         + [("pogostick-v1-lidar.stepping", "control", stepping(checks)),
            ("pogostick-v1-fence-medium.stepping", "control",
             stepping(novelty)),
            ("pogostick-v1-lidar.eval", "control", evaluate)])


@pytest.mark.parametrize("workload, mode, called", CASES,
                         ids=[f"{w}-{m}" for w, m, _ in CASES])
def test_a_runners_standin_is_the_calibrations(workload, mode, called):
    _, config, traffic = tiny(workload)
    runner = harness.load_runner(traffic)
    got = runner.standin(config, traffic, SEED, CPU, mode)
    want = called(config, traffic, SEED, CPU, mode)
    assert list(got) == list(want)
    assert [repr(v) for v in got.values()] == \
        [repr(v) for v in want.values()], (got, want)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_mode_the_runner_lacks_raises(workload):
    _, config, traffic = tiny(workload)
    runner = harness.load_runner(traffic)
    for mode in {"program", "pool", "half", "bfloat16"} - set(runner.FAULTS):
        with pytest.raises(ValueError):
            runner.standin(config, traffic, SEED, CPU, mode)
