"""The port's training CLI (ngx_torch/cli/train.py) on the CPU at a tiny
size: the chain run writes best.pt / final.pt / resume.pt and a monitor CSV
that ngx's own reader parses, -resume restores params and optimizer state
exactly, the plain path takes -pretrain and a dimension-preserving
-inject_novelty_at, and what cannot run is refused before any step."""

import csv
import json
from pathlib import Path

import pytest
import torch

from ngx.utils.monitor import load_results
from ngx_torch.cli import train as cli
from ngx_torch.utils.checkpoint import restore_checkpoint

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CHAIN = "NovelGridworld-v2,NovelGridworld-v3"
TINY = ["-num_envs", "128", "-rollout", "4", "-epochs", "1",
        "-episode_cap", "6", "-device", "cpu"]


def _csv(log):
    path = Path(log) / "progress.monitor.csv"
    with open(path) as f:
        header = json.loads(f.readline()[1:])
        rows = list(csv.reader(f))
    return header, rows


def test_chain_run_saves_logs_and_resumes(tmp_path):
    ck, log = tmp_path / "ck", tmp_path / "log"
    argv = ["-chain", CHAIN, "-chain_ckpts",
            str(ROOT / "trained_agents_torch/chain"), *TINY,
            "-steps", "1536", "-updates_per_launch", "2",
            "-reward_mode", "solve", "-best_metric", "solve",
            "-bc_anchor", str(ROOT / "demos/NovelGridworld-v3.npz"),
            "-ckpt", str(ck), "-log", str(log)]
    cli.main(argv)
    assert sorted(p.name for p in ck.iterdir()) == ["best.pt", "final.pt",
                                                    "resume.pt"]
    header, rows = _csv(log)
    assert sorted(header) == ["env_id", "t_start"]
    assert header["env_id"] == "NovelGridworld-v3"
    assert rows[0] == ["r", "l", "t"] and len(rows) == 4
    assert len(load_results(str(log))) == 3       # ngx's own reader
    final = restore_checkpoint(str(ck / "final.pt"))
    assert final["config"]["chain"] == CHAIN
    assert final["config"]["hidden"] == [64, 64]
    resume = restore_checkpoint(str(ck / "resume.pt"))
    assert set(resume) == {"params", "opt_state"}
    for k, v in final["params"].items():
        assert torch.equal(resume["params"][k], v), k

    # -resume restores the params and the Adam state exactly
    p = cli.build_parser()
    args = p.parse_args(argv[:-4] + ["-resume", str(ck / "resume.pt")])
    cfg = cli.validate(p, args)[0]
    carry, _, refresh = cli.setup(args, cfg, None)
    assert refresh is not None and len(carry) == 7
    for k, v in carry[0].model.state_dict().items():
        assert torch.equal(v, resume["params"][k]), k
    got, want = carry[0].opt.state_dict(), resume["opt_state"]
    assert got["param_groups"] == want["param_groups"]
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    cli.main(argv[:-4] + ["-resume", str(ck / "resume.pt"), "-steps", "512",
                          "-ckpt", str(tmp_path / "ck2"),
                          "-log", str(tmp_path / "log2")])
    assert len(_csv(tmp_path / "log2")[1]) == 2


def test_plain_run_with_pretrain_and_injection(tmp_path):
    """Without -chain: a behaviour-cloning warm start, then remapaction
    injected at update 1 of 2 (it keeps the obs and action dims)."""
    log = tmp_path / "log"
    cli.main(["-env", "NovelGridworld-Pogostick-v1", *TINY, "-steps", "1024",
              "-pretrain", str(ROOT / "demos/NovelGridworld-Pogostick-v1.npz"),
              "-pretrain_steps", "3", "-inject_novelty_at", "512",
              "-novelty", "remapaction", "-ckpt", str(tmp_path / "ck"),
              "-log", str(log)])
    assert len(_csv(log)[1]) == 3
    assert (tmp_path / "ck" / "final.pt").is_file()


POGO = ["-env", "NovelGridworld-Pogostick-v1"]


@pytest.mark.parametrize("extra,message", [
    (POGO + ["-rollout_backend", "xla"], "Queue 1 item 5"),
    (POGO + ["-inject_novelty_at", "1024", "-novelty", "fence",
             "-novelty_difficulty", "medium", "-novelty_arg1", "oak"],
     "changes the obs/action dims"),
    (POGO + ["-inject_novelty_at", "100"],
     "must land strictly inside the run"),
    (["-chain", CHAIN, "-inject_novelty_at", "1024"],
     "mutually exclusive")])
def test_refused_at_argument_time(tmp_path, monkeypatch, capsys, extra,
                                  message):
    """Each is refused by the argument parser (exit code 2) before a
    trainer is built or a log is opened."""
    def no_setup(*a, **k):
        raise AssertionError("a trainer was built")

    monkeypatch.setattr(cli, "setup", no_setup)
    with pytest.raises(SystemExit) as e:
        cli.main([*TINY, "-steps", "2048", "-log", str(tmp_path / "log"),
                  *extra])
    assert e.value.code == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "log").exists()
