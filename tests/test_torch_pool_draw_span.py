"""The pool draw's span (``ngx_torch.train.pool_draw``, rl/train.py
``draw_pool``) on the CPU at a tiny size: inside a profiler session a
pool-mode train step (a spec with reset edits, fence medium here) records
one such span an update, nested in the ``ngx_torch.train.pool`` phase, with
the pool's rows (B x 4) and the spec's reset edits as its counts; a step on
a spec without reset edits (native mode: plain, or the wooden axe novelty)
records none, and nothing is recorded outside a session."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ngx_torch as nt
from ngx_torch.ops import threefry as TF
from ngx_torch.rl import train as Tt
from ngx_torch.utils import trace

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

POGO = "NovelGridworld-Pogostick-v1"
CFG = dict(num_envs=128, rollout_steps=4, num_minibatches=2, epochs=1,
           hidden=(16, 16), episode_cap=5)
UPDATES = 2


def _steps(novelty):
    """The spans of ``UPDATES`` train steps recorded in one profiler
    session by a fresh recorder, and the trainer's reset mode."""
    spec = nt.make_spec(POGO)
    if novelty:
        spec = nt.inject_novelty(spec, *novelty)
    init, step = Tt.make_train(Tt.PPOConfig(env_id=POGO, **CFG),
                               spec_override=spec, device="cpu")
    key = TF.key(7)
    carry = init(key)
    rec = trace.Recorder()
    kept, trace.RECORDER = trace.RECORDER, rec
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for u in range(UPDATES):
                carry, _ = step(carry, TF.fold_in(key, u + 1))
    finally:
        trace.RECORDER = kept
    return rec.spans, step.reset_source


def test_a_pool_step_records_its_draw():
    spans, source = _steps(("fence", "medium", "oak"))
    assert source == "pool"
    draws = [s for s in spans if s.name == "ngx_torch.train.pool_draw"]
    assert len(draws) == UPDATES
    for s in draws:
        assert s.parent is not None and s.parent.name == "ngx_torch.train.pool"
        assert s.counts == {"rows": CFG["num_envs"] * Tt.POOL_SLOTS,
                            "edits": 1}
        assert s.start_ns <= s.end_ns
    assert len({id(s.parent) for s in draws}) == UPDATES


@pytest.mark.parametrize("novelty", [None, ("axe", "easy", "wooden")])
def test_a_native_step_records_no_draw(novelty):
    spans, source = _steps(novelty)
    assert source == "native"
    assert spans and not [s for s in spans
                          if s.name == "ngx_torch.train.pool_draw"]


def test_no_draw_is_recorded_outside_a_session():
    spec = nt.inject_novelty(nt.make_spec(POGO), "fence", "medium", "oak")
    init, step = Tt.make_train(Tt.PPOConfig(env_id=POGO, **CFG),
                               spec_override=spec, device="cpu")
    rec = trace.Recorder()
    kept, trace.RECORDER = trace.RECORDER, rec
    try:
        step(init(TF.key(1)), TF.key(2))
    finally:
        trace.RECORDER = kept
    assert rec.spans == []
