"""The program's span recorder (ngx_torch/utils/trace.py) on the CPU, at tiny
sizes: a keyed ``make_train`` step (native and pool mode), a keyed chain
refresh and step (``make_train_chain``) and a keyed ``make_eval`` run.

Outside a profiler session nothing is recorded.  Inside one every span is
recorded with its parent, on the profiler's own clock (each matches its
profiler event within 1 ms; a monotonic-clock stamp would miss by years),
the top-level spans tile the step, the counts are the loops' own, and the
results are bit for bit those of a run without spans."""

import contextlib
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ngx_torch as nt
from ngx_torch.ops import threefry as TF
from ngx_torch.rl import curriculum as TC
from ngx_torch.rl import evaluate as TE
from ngx_torch.rl import train as Tt
from ngx_torch import vector as V
from ngx_torch.utils import trace
from ngx_torch.utils.checkpoint import restore_checkpoint

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
POGO = "NovelGridworld-Pogostick-v1"
SOLVER = (ROOT / "trained_agents_torch" / "NovelGridworld-Pogostick-v1_solver"
          / "best.pt")
CHAIN = ["NovelGridworld-v2", "NovelGridworld-v3"]
CFG = dict(num_envs=128, rollout_steps=6, num_minibatches=2, epochs=1,
           hidden=(16, 16), episode_cap=5)
EPISODES, EVAL_CAP = 32, 30
TILES = {
    "train": ["ngx_torch.train.acting", "ngx_torch.train.permutation",
              "ngx_torch.train.recompute", "ngx_torch.train.gae",
              "ngx_torch.train.update"],
    "pool": ["ngx_torch.train.pool", "ngx_torch.train.acting",
             "ngx_torch.train.permutation", "ngx_torch.train.recompute",
             "ngx_torch.train.gae", "ngx_torch.train.update"],
    "chain": ["ngx_torch.train.refresh", "ngx_torch.train.acting",
              "ngx_torch.train.permutation", "ngx_torch.train.recompute",
              "ngx_torch.train.gae", "ngx_torch.train.update"],
}
# each span name with the parents it may have (None: top level)
PARENTS = {
    "train": {"ngx_torch.train.draw": {"ngx_torch.train.acting",
                                       "ngx_torch.train.permutation"}},
    "pool": {"ngx_torch.train.draw": {"ngx_torch.train.pool",
                                      "ngx_torch.train.acting",
                                      "ngx_torch.train.permutation"},
             "ngx_torch.train.pool_draw": {"ngx_torch.train.pool"}},
    "chain": {"ngx_torch.train.draw": {"ngx_torch.train.acting",
                                       "ngx_torch.train.permutation"},
              "ngx_torch.chain.stage": {"ngx_torch.train.refresh"}},
    "eval": {"ngx_torch.eval.policy": {None},
             "ngx_torch.eval.reset": {None, "ngx_torch.eval.run"},
             "ngx_torch.eval.run": {None}},
}
for kind in ("train", "pool", "chain"):
    PARENTS[kind].update({name: {None} for name in TILES[kind]})
KINDS = list(PARENTS)


@contextlib.contextmanager
def counting(module, name, calls):
    """``module.name`` wrapped so that each call appends to ``calls``; the
    wrapper keeps the wrapped function's attributes."""
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = inner(*args, **kwargs)
        if callable(out) and hasattr(out, "get_obs"):
            # make_step: count the calls of the step function it returns
            step = out

            def counted(*a, **kw):
                calls.append(1)
                return step(*a, **kw)
            counted.get_obs = step.get_obs
            return counted
        calls.append(1)
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, inner)


def _build(kind):
    """``(setup, go)``: ``setup()`` builds the program's state from a fixed
    key, ``go(state)`` runs the piece of work and returns its results."""
    if kind in ("train", "pool"):
        cfg = Tt.PPOConfig(env_id=POGO, **CFG)
        spec = (nt.inject_novelty(nt.make_spec(POGO), "fence", "medium",
                                  "oak") if kind == "pool" else None)
        init, step = Tt.make_train(cfg, spec_override=spec, device="cpu")
        assert step.reset_source == ("pool" if kind == "pool" else "native")
        return (lambda: init(TF.key(3)),
                lambda carry: step(carry, TF.key(4)))
    if kind == "chain":
        cfg = Tt.PPOConfig(env_id=CHAIN[-1], **CFG)
        init, step = TC.make_train_chain(cfg, CHAIN, [None], pool_size=16,
                                         device="cpu")

        def go(carry):
            return step(step.refresh_pool(carry, TF.key(5)), TF.key(6))
        return lambda: init(TF.key(3)), go
    run = TE.make_eval(nt.make_spec(POGO), cap=EVAL_CAP, device="cpu")
    # the solver ends its episodes early: resets of done rows inside the run
    params = restore_checkpoint(str(SOLVER))["params"]
    return (lambda: None,
            lambda _: run(params, TF.key(8), EPISODES))


def _flat(out):
    """Every tensor and number of a result, in order, for a bit-for-bit
    comparison."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (int, float)):
        return [torch.tensor(out, dtype=torch.float64)]
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _flat(out[k])]
    if isinstance(out, Tt.TrainState):
        return [p.detach() for p in out.model.parameters()]
    if isinstance(out, (tuple, list)):
        return [x for v in out for x in _flat(v)]
    if hasattr(out, "__dict__"):           # EnvState
        return [v for _, v in sorted(vars(out).items())
                if isinstance(v, torch.Tensor)]
    return []


def _refuse_recording(*args, **kwargs):
    raise AssertionError("a span recorded outside a profiler session")


@pytest.fixture(scope="module")
def runs():
    """For each kind: the results without a profiler (with a fresh
    recorder, and a recording refused), the results, spans and
    profiler events of the same work inside a profiler session, the host
    clock around the work and the counted loop steps."""
    out = {}
    for kind in KINDS:
        setup, go = _build(kind)
        go(setup())                                 # warm-up
        off = trace.Recorder()
        kept, trace.RECORDER = trace.RECORDER, off
        recording, trace._Recording = trace._Recording, _refuse_recording
        try:
            plain = go(setup())
        finally:
            trace.RECORDER, trace._Recording = kept, recording
        state = setup()
        stage_steps, eval_steps = [], []
        with counting(TC, "make_step", stage_steps):
            setup2, go2 = _build(kind)
        with profile(activities=[ProfilerActivity.CPU]) as prof, \
                counting(V.KeyedVecEnv, "step_rows", eval_steps):
            t0 = time.time_ns()
            traced = go2(state)
            t1 = time.time_ns()
        events = [(e.name(), e.start_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("ngx_torch.")]
        out[kind] = dict(plain=plain, traced=traced, off=off.spans,
                         spans=trace.spans(), events=events, t0=t0, t1=t1,
                         stage_steps=len(stage_steps),
                         eval_steps=len(eval_steps))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_no_span_outside_a_profiler_session(runs, kind):
    assert runs[kind]["off"] == []


@pytest.mark.parametrize("kind", KINDS)
def test_each_span_is_recorded_with_its_parent(runs, kind):
    spans = runs[kind]["spans"]
    got = {}
    for s in spans:
        got.setdefault(s.name, set()).add(
            None if s.parent is None else s.parent.name)
        assert s.parent is None or s.parent in spans
        assert s.start_ns <= s.end_ns
        if not torch.cuda.is_initialized():
            assert s.device_ms() is None     # no CUDA events without CUDA
    assert set(got) == set(PARENTS[kind])
    for name, parents in got.items():
        assert parents <= PARENTS[kind][name], name
    if kind == "eval":
        # the done rows' resets lie inside the run, the start reset before
        assert got["ngx_torch.eval.reset"] == {None, "ngx_torch.eval.run"}


@pytest.mark.parametrize("kind", KINDS)
def test_spans_share_the_profilers_clock(runs, kind):
    """Each span opens its profiler event: the two starts, on one clock,
    lie within 1 ms (the n-th span of a name against that name's n-th
    event)."""
    spans, events = runs[kind]["spans"], sorted(runs[kind]["events"],
                                                key=lambda e: e[1])
    assert sorted(n for n, _ in events) == sorted(s.name for s in spans)
    worst = 0
    for name in {s.name for s in spans}:
        mine = [s.start_ns for s in spans if s.name == name]
        theirs = [start for n, start in events if n == name]
        worst = max(worst, *(abs(a - b) for a, b in zip(mine, theirs)))
    assert worst < 1_000_000, worst


@pytest.mark.parametrize("kind", ["train", "pool", "chain"])
def test_the_top_level_spans_tile_the_step(runs, kind):
    """The top-level spans come in the phases' order, end to end, and
    cover the work's wall time but for the calls around them."""
    r = runs[kind]
    top = [s for s in r["spans"] if s.parent is None]
    assert [s.name for s in top] == TILES[kind]
    for a, b in zip(top, top[1:]):
        assert a.end_ns <= b.start_ns
    wall = r["t1"] - r["t0"]
    covered = sum(s.end_ns - s.start_ns for s in top)
    assert covered >= 0.95 * wall, (covered, wall)


def test_stage_steps_count_the_steps_played(runs):
    r = runs["chain"]
    stages = [s for s in r["spans"] if s.name == "ngx_torch.chain.stage"]
    assert len(stages) == len(CHAIN) - 1
    assert sum(s.counts["steps"] for s in stages) == r["stage_steps"] > 0


def test_an_evaluation_counts_its_steps_and_host_reads(runs):
    r = runs["eval"]
    (run,) = [s for s in r["spans"] if s.name == "ngx_torch.eval.run"]
    assert run.counts["steps"] == r["eval_steps"] > 0
    # a bool a step, then the four metrics' floats
    assert run.counts["host_reads"] == r["eval_steps"] + 4
    resets = [s for s in r["spans"] if s.name == "ngx_torch.eval.reset"]
    assert resets[0].counts["envs"] == EPISODES
    assert all(s.counts["envs"] > 0 for s in resets)


@pytest.mark.parametrize("kind", KINDS)
def test_spans_change_no_result(runs, kind):
    plain, traced = _flat(runs[kind]["plain"]), _flat(runs[kind]["traced"])
    assert len(plain) == len(traced) > 0
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_the_recorder_keeps_the_latest_session_only():
    rec = trace.Recorder()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("ngx_torch.test.a"):
            with rec.span("ngx_torch.test.b") as b:
                b.count("n", 3)
    first = rec.spans
    assert [s.name for s in first] == ["ngx_torch.test.a", "ngx_torch.test.b"]
    assert first[1].parent is first[0] and first[1].counts == {"n": 3}
    with rec.span("ngx_torch.test.off") as off:
        off.count("n", 1)
    assert rec.spans is first
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("ngx_torch.test.c"):
            pass
    assert [s.name for s in rec.spans] == ["ngx_torch.test.c"]
    assert [s.name for s in first] == ["ngx_torch.test.a", "ngx_torch.test.b"]


def test_the_phases_view_times_each_phase():
    """``Phases`` with a dict appends one host-clock time a phase, under
    the span name's last part, with or without a profiler."""
    phases = {}
    with trace.Phases(phases, torch.device("cpu")) as phase:
        phase("ngx_torch.test.one")
        phase("ngx_torch.test.two")
    assert list(phases) == ["one", "two"]
    assert all(len(v) == 1 and v[0] >= 0 for v in phases.values())
    with pytest.raises(ValueError):
        with trace.Phases(phases, torch.device("cpu")) as phase:
            phase("ngx_torch.test.one")
            raise ValueError
    assert len(phases["one"]) == 1       # a failed phase is not timed
