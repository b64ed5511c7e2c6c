"""The port's env-stepping entry points on the CPU: throughput_fn and the
perf CLI (ngx_torch/cli/perf.py), which on the CPU run the plain twins."""

import json

import numpy as np
import pytest
import torch

import jax

import ngx
from ngx.ops import pallas_rollout as P
import ngx_torch as nt
from ngx_torch.cli import perf
from ngx_torch.ops import rollout as R
from ngx_torch.vector import throughput_fn

# one torch thread per test process: xdist runs several on the CPU, where
# more threads only contend (the port's suite runs twice as fast)
torch.set_num_threads(1)


def test_throughput_fn_is_the_prng_rollout():
    """run(seed) -> (state, mean_reward): the 'prng' rollout in blocks of
    512 envs (the whole batch below that), whose mean matches ngx's kernel
    in interpret mode at the same block (B 64 there: the interpret calls
    stay small)."""
    env_id, T, seed = "NovelGridworld-v3", 4, 9
    spec = nt.make_spec(env_id)
    state, mean = throughput_fn(spec, 128, T, device="cpu")(seed)
    st, rsum, dcount = R.rollout_plain(spec, 128, T, seed, block=128)
    assert torch.equal(state.map, st.map) and state.map.shape == (128, 100)
    assert float(mean) == float(rsum.sum() / (128 * T))
    assert int(dcount.sum()) > 0                    # resets on the path
    state, mean = throughput_fn(spec, 64, T, device="cpu")(seed)
    run = P.make_pallas_rollout(
        ngx.make_spec(env_id), 64, T, block=64, interpret=True)
    want = jax.jit(run)(seed)
    np.testing.assert_allclose(float(mean), float(want[1]), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(want[0].map), state.map.numpy())


@pytest.mark.parametrize("mode", [[], ["--policy", "-block", "64"],
                                  ["--trainer"]])
def test_perf_cli_prints_one_json_line(mode, capsys):
    perf.main(["-batch", "128", "-steps", "4", "-repeats", "1",
               "-device", "cpu"] + mode)
    lines = capsys.readouterr().out.strip().splitlines()
    parsed = []
    for line in lines:
        try:
            parsed.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    assert len(parsed) == 1 and parsed[0] == json.loads(lines[-1])
    out = parsed[0]
    assert out["batch"] == 128 and out["steps"] == 4
    assert out["device"] == "cpu"
    assert out["steps_per_s"] and all(v > 0 for v in
                                      out["steps_per_s"].values())


def test_entry_points_default_to_the_card():
    """throughput_fn, rollout, make_rollout and the perf CLI run on the
    card unless asked for the CPU, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    spec = nt.make_spec("NovelGridworld-v3")
    calls = (lambda: throughput_fn(spec, 128, 2)(0),
             lambda: R.rollout(spec, 128, 2, 0, block=128),
             lambda: R.make_rollout(spec, 128, 2, block=128)(0),
             lambda: R.pool_reset(spec, 128, 0),
             lambda: perf.main(["-batch", "128", "-steps", "2"]))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
