"""The mixes tests (``test_portbench_mixes.py``) on cells whose traffic
names a runner that extends another.

Those tests size a cell for the CPU (``tiny``) and pick its stand-ins (the
control) by the name of its traffic's runner: ``train``, ``stepping``, and
otherwise eval.  A runner of :data:`EXTENDS` is shown to them under the
name of the runner it extends, so its cell is sized as that kind's, while
the cell still runs its own runner module, and the stand-ins of a
configuration with a ``novelty`` are the novelty reference's."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.reference import checks, novelty  # noqa: E402

import test_portbench_mixes as mixes  # noqa: E402

# runner -> the runner it extends
EXTENDS = {"novelty_train": "train", "novelty_stepping": "stepping"}


class HarnessView:
    """:mod:`portbench.harness` with a runner of :data:`EXTENDS` named as
    the runner it extends (its own name kept under ``module``)."""

    def __getattr__(self, name):
        return getattr(harness, name)

    @staticmethod
    def find_cell(bench, workload, root=harness.ROOT):
        cell = harness.find_cell(bench, workload, root)
        runner = cell["traffic"]["runner"]
        if runner in EXTENDS:
            cell["traffic"] = dict(cell["traffic"], runner=EXTENDS[runner],
                                   module=runner)
        return cell

    @staticmethod
    def load_runner(traffic):
        return harness.load_runner(
            dict(traffic, runner=traffic.get("module", traffic["runner"])))


class ChecksView:
    """:mod:`portbench.reference.checks` whose stand-ins are
    :mod:`portbench.reference.novelty`'s for a configuration with a
    ``novelty``."""

    def __getattr__(self, name):
        return getattr(checks, name)

    @staticmethod
    def standin_train(config, traffic, key, device, tf32=False, fault=None,
                      root="."):
        if "novelty" in config:
            return novelty.standin_train(config, traffic, key, device,
                                         tf32=tf32, fault=fault)
        return checks.standin_train(config, traffic, key, device, tf32=tf32,
                                    fault=fault, root=root)

    @staticmethod
    def standin_stepping(config, traffic, seeds, device, sum_dtype):
        if "novelty" in config:
            return novelty.standin_stepping(config, traffic, seeds, device,
                                            sum_dtype)
        return checks.standin_stepping(config, traffic, seeds, device,
                                       sum_dtype)


mixes.harness = HarnessView()
mixes.checks = ChecksView()
