"""Each traffic mix driven through the port's path at a tiny size on the CPU
(device ``cpu``: the plain twins) and judged by the reference, as a run
judges it; then the same with the timed path broken underneath, once for
each fault the cell can have, where ``correct`` has to come out false; and
the control (the reference in TF32) on the card, where there is one.  A
cell's sizes, its control and what it judges come from its runner module,
so a cell of a new runner is tested here without an edit.

Run: ``python -m pytest portbench/tests -q`` from the root of the repo."""

import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

BENCH = harness.load_benchmark(ROOT)
CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345          # past 32 signed bits, as a run's may be


def tiny(workload, card=False):
    """The cell at a size the CPU runs in seconds (with ``card``, the size
    of the control on the card), as its runner sizes it, with its own
    limits."""
    cell = harness.find_cell(BENCH, workload, ROOT)
    config, traffic = harness.load_runner(cell["traffic"]).tiny(
        cell["config"], cell["traffic"], card)
    return cell, config, traffic


def drive(workload, device=CPU, seconds=0.5):
    """Set-up, a short window and the check, as ``run.py`` drives a cell;
    returns ``(correct, numbers, ctx)``."""
    cell, config, traffic = tiny(workload)
    c = harness.load_runner(traffic).Cell(config, traffic, SEED, device)
    ctx = {}
    c.window(seconds, ctx)
    c.release()
    numbers = c.check()
    correct, _ = harness.judge(numbers, cell["limits"])
    return correct, numbers, ctx


WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_port_agrees_with_the_reference(workload):
    correct, numbers, ctx = drive(workload)
    assert correct, numbers
    assert ctx["attempted"] > 0 and ctx["failed"] == 0
    end_to_end = harness.find_cell(BENCH, workload, ROOT)["end_to_end"]
    # run.py adds set-up's time and the card's allocator peak
    metrics = harness.read_metrics(
        end_to_end, dict(ctx, setup_s=1.0, memory_peak_bytes=2 ** 20), ROOT)
    assert set(metrics) == {m["name"] for m in end_to_end}
    assert all(m["value"] > 0 for m in metrics.values())


def no_profiler(fn):
    """``trace.profile``'s shape without the profiler (the CPU has no
    device timeline)."""
    return fn(), None


@pytest.mark.parametrize("workload", ["pogostick-v1-lidar.stepping",
                                      "pogostick-v1-lidar.eval"])
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_a_traced_run_judges_its_whole_sample(workload, seed):
    cell, config, traffic = tiny(workload)
    c = harness.load_runner(traffic).Cell(config, traffic, seed, CPU)
    ctx = {}
    c.trace(ctx, no_profiler)
    kept = len(c.kept)
    c.release()
    numbers = c.check()
    assert kept == traffic["samples"]
    assert all(math.isfinite(v) for v in numbers.values()), numbers
    assert harness.judge(numbers, cell["limits"])[0], numbers


@pytest.mark.parametrize("workload", ["pogostick-v1-lidar.train",
                                      "chain-v2-v5.train"])
def test_a_traced_train_run_reads_its_window(workload):
    cell, config, traffic = tiny(workload)
    c = harness.load_runner(traffic).Cell(config, traffic, SEED, CPU)
    ctx = {"seconds": 0.0}
    c.trace(ctx, no_profiler)
    K = traffic["fetch_every"]
    assert len(ctx["step_ms"]) == K and ctx["attempted"] == 4 * K
    names = {"env_steps_per_s.train", "step_ms_p90.train"}
    metrics = harness.read_metrics(
        [m for m in cell["per_layer"] if m["name"] in names], ctx, ROOT)
    assert set(metrics) == names
    assert all(m["value"] > 0 for m in metrics.values())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_window_too_short_still_judges_its_whole_sample(workload):
    correct, numbers, _ = drive(workload, seconds=0.0)
    assert all(math.isfinite(v) for v in numbers.values()), numbers
    assert correct, numbers


@pytest.mark.parametrize("workload", ["pogostick-v1-lidar.stepping",
                                      "pogostick-v1-lidar.eval"])
def test_nothing_to_judge_is_not_correct(workload):
    cell, config, traffic = tiny(workload)
    numbers = harness.load_runner(traffic).check(config, traffic, [], CPU)
    assert not harness.judge(numbers, cell["limits"])[0], numbers


# ---- faults planted in the program, underneath the harness -----------------
def _train_fault(monkeypatch, fault):
    from ngx_torch.rl import curriculum, train

    if fault == "alter":
        inner = train.train_rollout

        def altered(*args, **kwargs):
            out = list(inner(*args, **kwargs))
            out[2] = out[2].clone()
            out[2][0, 0] = (out[2][0, 0] + 1) % args[0].n_actions
            return tuple(out)

        for m in (train, curriculum):
            monkeypatch.setattr(m, "train_rollout", altered)
    else:
        inner_core = train.make_ppo_core

        def half_core(cfg, bc_data=None, mesh=None):
            gae, update = inner_core(cfg, bc_data, mesh)

            def halved(ts, batch, perms=None):
                nm = cfg.num_minibatches
                if fault == "unchanged":
                    zero = torch.zeros((cfg.epochs, nm))
                    return zero, zero, zero
                out = []
                for p in perms:
                    idx = p.reshape(nm, -1).clone()
                    mb = idx.shape[1]
                    idx[:, mb // 2:] = idx[:, :mb - mb // 2]
                    out.append(idx.reshape(-1))
                return update(ts, batch, perms=out)

            return gae, halved

        monkeypatch.setattr(train, "make_ppo_core", half_core)


@pytest.mark.parametrize("workload", ["pogostick-v1-lidar.train",
                                      "chain-v2-v5.train"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "alter"])
def test_a_broken_train_step_is_not_correct(monkeypatch, workload, fault):
    _train_fault(monkeypatch, fault)
    correct, numbers, _ = drive(workload)
    assert not correct, numbers


def _stepping_fault(monkeypatch, fault):
    import ngx_torch.vector as V
    from ngx_torch.ops.rollout import rollout

    inner = V.throughput_fn

    def broken(spec, batch, steps, **kw):
        run = inner(spec, batch, steps, **kw)

        def fn(seed):
            if fault == "unchanged":
                return inner(spec, batch, 0, **kw)(seed)
            if fault == "half":
                state, rsum, _ = rollout(spec, batch, steps, seed,
                                         device=kw.get("device"))
                h = batch // 2
                return state, rsum[:h].sum() / (h * steps)
            state, mean = run(seed)
            state.map[0, 0] += 1
            return state, mean
        return fn

    monkeypatch.setattr(V, "throughput_fn", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "alter"])
def test_a_broken_stepping_call_is_not_correct(monkeypatch, fault):
    _stepping_fault(monkeypatch, fault)
    correct, numbers, _ = drive("pogostick-v1-lidar.stepping")
    assert not correct, numbers


def _eval_fault(monkeypatch, fault):
    import ngx_torch.rl.evaluate as E
    import ngx_torch.vector as V

    if fault == "unchanged":
        def frozen_step(self, state, actions, reset_keys):
            obs = self.get_obs(state)
            zero = torch.zeros((state.batch,), dtype=torch.float32)
            return state, obs, zero, zero.to(torch.bool), None

        monkeypatch.setattr(V.KeyedVecEnv, "step_rows", frozen_step)
        return
    inner = E.make_eval

    def broken(spec, **kw):
        run = inner(spec, **kw)

        def fn(params, key, episodes):
            if fault == "half":
                return run(params, key, episodes // 2)
            out = dict(run(params, key, episodes))
            out["mean_return"] += 1.0
            return out
        return fn

    monkeypatch.setattr(E, "make_eval", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "alter"])
def test_a_broken_evaluation_is_not_correct(monkeypatch, fault):
    _eval_fault(monkeypatch, fault)
    correct, numbers, _ = drive("pogostick-v1-lidar.eval")
    assert not correct, numbers


# ---- the control: the reference in TF32, which only the card has ------------
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control is TF32 (bfloat16 sums for stepping), "
                    "which needs the card")
    cell, config, traffic = tiny(workload, card=True)
    numbers = harness.load_runner(traffic).standin(
        config, traffic, SEED, torch.device("cuda", 0), "control")
    assert not harness.judge(numbers, cell["limits"])[0], numbers
