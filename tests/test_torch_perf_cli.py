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
    if not mode:          # ngx's five variants, in ngx's order, the twin
        assert list(out["steps_per_s"]) == [
            "full", "hash", "fixed", "no_auto_reset", "packed", "prng_twin"]
        assert out["device_ms"] == {}     # no device time on the CPU
    if mode == ["--trainer"]:     # the acting backends' A/B, by phase
        assert list(out["steps_per_s"]) == ["train_step_xla",
                                            "train_step_pallas"]
        assert sorted(out["phases_ms"]["xla"]) == [
            "acting", "gae", "recompute", "update"]


def test_perf_cli_trainer_novelty_and_profile(tmp_path, capsys):
    """--trainer -novelty A/Bs on the injected spec (the kernel side draws
    its pool, the xla side none); --profile writes a trace."""
    perf.main(["-batch", "128", "-steps", "4", "-repeats", "1", "-device",
               "cpu", "--trainer", "-novelty", "fence:medium:oak"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "pool" in out["phases_ms"]["pallas"]
    assert "pool" not in out["phases_ms"]["xla"]
    perf.main(["-batch", "128", "-steps", "2", "-repeats", "1", "-device",
               "cpu", "--no-twin", "--profile", "-profile_dir",
               str(tmp_path / "prof")])
    assert (tmp_path / "prof" / "throughput_fn.json").is_file()


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


def test_kernel_ab_sweeps_tile_geometries():
    """cli/kernel_ab.py's geometry sweeps: every (E envs, N threads) pair of
    the two lists with N >= E, the E x {E, 2E, 4E} grid among them, and
    every (threads, lanes) pair of the rollout modes; and its timer, which
    runs only on a card inside each checkout, compiles."""
    from ngx_torch.cli import kernel_ab

    g = kernel_ab.geometries("16,32,64", "16,32,64,128,256")
    assert len(g) == 12
    assert {f"{e}x{k * e}" for e in (16, 32, 64) for k in (1, 2, 4)} <= set(g)
    assert all(int(n) >= int(e) for e, n in (x.split("x") for x in g))
    # the rollout modes: threads a block x the fewest lanes a reset
    assert kernel_ab.rollout_geometries("64,128", "1,2,4") == [
        "64x1", "64x2", "64x4", "128x1", "128x2", "128x4"]
    assert kernel_ab.rollout_geometries("128", "") == ["128x1"]
    compile(kernel_ab._TIMER, "kernel_ab timer", "exec")


def test_kernel_ab_sass_mode_reads_ptxas_and_cuobjdump(monkeypatch):
    """-mode sass's parsers: ptxas's lines by kernel, and cuobjdump's SASS
    by kernel (instructions less the end's NOPs, and the BSSY among them,
    predicated ones too); its build script compiles."""
    import types

    from ngx_torch.cli import kernel_ab
    from ngx_torch.ops import _build

    log = ("ptxas info    : Compiling entry function '_Z1kILi0EEvv' for "
           "'sm_90a'\nptxas info    : Used 64 registers\n"
           "    24 bytes stack frame, 28 bytes spill stores\n"
           "ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'\n"
           "ptxas info    : Used 8 registers\n")
    assert kernel_ab.ptxas_lines(log) == {
        "_Z1kILi0EEvv": ["ptxas info    : Used 64 registers",
                         "24 bytes stack frame, 28 bytes spill stores"],
        "_Z1gv": ["ptxas info    : Used 8 registers"]}
    listing = """
\t\tFunction : _Z1kILi0EEvv
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe40000000800 */
        /*0010*/              @!P0 BSSY B0, 0x1f0 ;         /* 0x000001d000008945 */
        /*0020*/                   BSSY B1, 0x1f0 ;         /* 0x000001d000008945 */
        /*0030*/                   EXIT ;
        /*0040*/                   NOP;
\t\tFunction : _Z1gv
        /*0000*/                   EXIT ;
"""
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setattr(_build.subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=listing, returncode=0))
    assert _build.sass_counts("lib.so") == {"_Z1kILi0EEvv": (4, 2),
                                            "_Z1gv": (1, 0)}
    compile(kernel_ab._BUILD, "kernel_ab build", "exec")
