"""The port's training CLI on ngx's keys (ngx_torch/cli/train.py, ngx's
key schedule) against ngx's (ngx/cli/train.py) on the CPU: the
same tiny arguments (tests/test_torch_cli_train.py's ``TINY``) and
``-seed`` give the same ``r`` and ``l`` columns of
``progress.monitor.csv``, row for row, plain, with ``-chain`` on random
stages, and with ``-pretrain`` and ``-inject_novelty_at``; and the final
parameters within tests/test_torch_ppo.py's rtol 1e-5 / atol 1e-6 (the
columns alone would miss a wrong draw whose episodes end alike: at a cap
of 6 most returns are the step costs).  ngx's ``-inject_novelty_at``
draws its remapaction from numpy's global state (``inject_novelty``'s
default ``rng=np.random``), as the port's does, so each run starts from
the same ``np.random.seed``.  Both run
``-rollout_backend xla``: ngx's ``auto`` off a TPU is its unfused loop,
the port's the kernel (its twin on the CPU), which draws its actions
otherwise."""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from ngx.cli import train as ngx_cli
from ngx.utils.checkpoint import restore_pytree
from ngx_torch.cli import train as cli
from ngx_torch.rl.evaluate import as_policy
from ngx_torch.utils.checkpoint import restore_checkpoint

from test_torch_cli_train import CHAIN, TINY
from test_torch_keyed_train import _params_close

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
POGO = "NovelGridworld-Pogostick-v1"
CASES = {
    "plain": ["-env", POGO, "-steps", "1024", "-seed", "3"],
    "chain": ["-chain", CHAIN, "-steps", "1536", "-updates_per_launch", "2",
              "-seed", "4"],
    "pretrain-inject": [
        "-env", POGO, "-steps", "1024", "-seed", "5",
        "-pretrain", str(ROOT / "demos/NovelGridworld-Pogostick-v1.npz"),
        "-pretrain_steps", "100", "-inject_novelty_at", "512",
        "-novelty", "remapaction"],
}


def _rl(log):
    """The ``r`` and ``l`` columns of the run's monitor CSV."""
    with open(Path(log) / "progress.monitor.csv") as f:
        f.readline()
        return [(row["r"], row["l"]) for row in csv.DictReader(f)]


@pytest.mark.parametrize("case", list(CASES))
def test_keyed_cli_matches_ngx(tmp_path, case):
    args = [*CASES[case], "-rollout_backend", "xla"]
    tiny = [a for a in TINY if a not in ("-device", "cpu")]
    np.random.seed(0)
    ngx_cli.main([*tiny, *args, "-log", str(tmp_path / "ngx"),
                  "-ckpt", str(tmp_path / "ck_ngx")])
    np.random.seed(0)
    cli.main([*TINY, *args, "-log", str(tmp_path / "port"),
              "-ckpt", str(tmp_path / "ck_port")])
    want = _rl(tmp_path / "ngx")
    assert len(want) == {"plain": 2, "chain": 3, "pretrain-inject": 2}[case]
    assert _rl(tmp_path / "port") == want
    final = as_policy(restore_checkpoint(str(tmp_path / "ck_port" /
                                             "final.pt"))["params"], "cpu")
    _params_close(final, restore_pytree(str(tmp_path / "ck_ngx" /
                                            "final"))["params"], case)

