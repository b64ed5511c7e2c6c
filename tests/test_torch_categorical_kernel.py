"""The categorical kernel's device code (ngx_torch/ops/csrc/categorical.cu)
built for the host with g++, through the wrapper's launch path
(ngx_torch/ops/categorical.py), against the plain twin
(ngx_torch/ops/threefry.py ``categorical``): the bits and the uniforms
exactly, the actions on B in {1, 3, 1,024}, A in {2, 17, 18, 40} (40 strides
the lanes), over two sets of keys.  The host's logf
(glibc) and torch's CPU log may differ in the last bit, so an action may
flip at a near-tie of two scores: the test counts the flips and holds each
to a score gap under 1e-5.  Over a 0 / -inf mask the actions are exact.  On
the card the kernel equals the twin bit for bit
(tests/test_torch_categorical_card.py).  About 10 s alone, the g++ build
included."""

import ctypes
import shutil
import subprocess

import pytest
import torch

import ngx_torch as nt
import ngx_torch.rl.curriculum as CUR
import ngx_torch.rl.evaluate as EV
from ngx_torch.ops import categorical as CK
from ngx_torch.ops import threefry as TF
from ngx_torch.ops._build import CSRC, declare_categorical
from ngx_torch.ops.categorical import categorical
from ngx_torch.utils import trace
from ngx_torch.utils.checkpoint import restore_checkpoint

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

# each key set is KEYS keys of its own
ROWS, ACTIONS, KEY_SETS = (1, 3, 1024), (2, 17, 18, 40), (0, 1)
KEYS = 8

# ngx_categorical on the host: each row's 32 lanes in turn, their bests
# reduced in lane order (cat_better is a strict total order, so any order
# finds the warp's result); ngx_categorical_parts exports the bits, the
# uniform and the Gumbel score of counters [0, n)
HOST_SHIM = r"""
#include "categorical.cu"

extern "C" int ngx_categorical(const long long* key, const float* logits,
                               int n, int n_actions, long long* out,
                               void*) {
  if (!key || !logits || !out || n < 1 || n_actions < 1 ||
      (unsigned long long)n * (unsigned long long)n_actions > 0xFFFFFFFFull)
    return 1;
  const TfKey k{(uint32_t)key[0], (uint32_t)key[1]};
  for (long long row = 0; row < n; ++row) {
    float best = 0.0f;
    int idx = -1;
    for (int lane = 0; lane < 32; ++lane) {
      float s;
      int i;
      cat_lane(k, logits + row * n_actions, n_actions,
               (unsigned long long)row * n_actions, lane, s, i);
      if (idx < 0 || cat_better(s, i, best, idx)) {
        best = s;
        idx = i;
      }
    }
    out[row] = idx;
  }
  return 0;
}

extern "C" void ngx_categorical_parts(const long long* key, int n,
                                      long long* bits, float* u, float* g) {
  const TfKey k{(uint32_t)key[0], (uint32_t)key[1]};
  for (int i = 0; i < n; ++i) {
    bits[i] = tf_bits(k, (uint32_t)i);
    u[i] = cat_uniform((uint32_t)bits[i]);
    g[i] = cat_gumbel(u[i]);
  }
}

extern "C" const char* ngx_error_string(int) { return "refused"; }
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's device code for the host")
    d = tmp_path_factory.mktemp("categorical")
    (d / "shim.cpp").write_text(HOST_SHIM)
    so = d / "libhost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    str(CSRC), "-o", str(so), str(d / "shim.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = declare_categorical(ctypes.CDLL(str(so)))
    lib.ngx_error_string.argtypes = [ctypes.c_int]
    lib.ngx_error_string.restype = ctypes.c_char_p
    P = ctypes.c_void_p
    lib.ngx_categorical_parts.argtypes = [P, ctypes.c_int, P, P, P]
    lib.ngx_categorical_parts.restype = None
    return lib


def _scores(key, logits):
    return TF.gumbel(key, logits.shape) + logits


def test_the_bits_and_uniforms_are_the_twins(host_lib):
    """Counters [0, 2^16) of several keys: the bits and the uniforms equal
    TF's exactly; the Gumbel scores within 2^-23 of torch's, relative to
    the larger of 1 and their size (glibc's logf and torch's log differ in
    the last bit on about 1% of them, which -log(-log(u)) carries out near
    0)."""
    n = 1 << 16
    for seed in range(KEYS):
        key = TF.fold_in(TF.key(seed), 3)
        bits = torch.empty((n,), dtype=torch.int64)
        u = torch.empty((n,), dtype=torch.float32)
        g = torch.empty((n,), dtype=torch.float32)
        host_lib.ngx_categorical_parts(key.data_ptr(), n, bits.data_ptr(),
                                       u.data_ptr(), g.data_ptr())
        assert torch.equal(bits, TF.bits(key, (n,)))
        want_u = TF.uniform(key, (n,), TF._TINY_F32, 1.0)
        assert torch.equal(u.view(torch.int32), want_u.view(torch.int32))
        want_g = TF.gumbel(key, (n,))
        assert float(((g - want_g).abs()
                      / want_g.abs().clamp(min=1.0)).max()) <= 2.0 ** -23


@pytest.mark.parametrize("key_set", KEY_SETS)
@pytest.mark.parametrize("n_actions", ACTIONS)
@pytest.mark.parametrize("rows", ROWS)
def test_the_actions_are_the_twins_up_to_near_ties(host_lib, rows, n_actions,
                                                   key_set):
    """Normal logits (scale 2) over ``KEYS`` keys: every action equal to the
    twin's but at a near-tie, where the twin's score of its own action
    exceeds that of the host's by under 1e-5."""
    gen = torch.Generator().manual_seed(rows * 100 + n_actions + key_set)
    flips = 0
    for seed in range(key_set * KEYS, (key_set + 1) * KEYS):
        key = TF.fold_in(TF.key(rows + seed), n_actions)
        logits = 2.0 * torch.randn((rows, n_actions), generator=gen)
        got = categorical(key, logits, lib=host_lib)
        want = TF.categorical(key, logits)
        assert got.dtype == torch.int64 and got.shape == (rows,)
        off = torch.nonzero(got != want).flatten()
        if len(off):
            s = _scores(key, logits)[off]
            gap = (s.gather(1, want[off, None]) - s.gather(1, got[off, None]))
            assert float(gap.abs().max()) < 1e-5, gap
        flips += len(off)
    # a near-tie within the last bit of log is rare
    assert flips <= max(1, rows * KEYS // 1000)


@pytest.mark.parametrize("key_set", KEY_SETS)
@pytest.mark.parametrize("n_actions", ACTIONS)
@pytest.mark.parametrize("rows", ROWS)
def test_a_masked_draw_is_exact(host_lib, rows, n_actions, key_set):
    """Logits of 0 and -inf (each row with at least one 0, and rows with
    all -inf, where argmax picks 0): the actions equal the twin's exactly."""
    gen = torch.Generator().manual_seed(7 * rows + n_actions + key_set)
    for seed in range(key_set * KEYS, (key_set + 1) * KEYS):
        key = TF.fold_in(TF.key(1000 + seed), rows)
        mask = torch.rand((rows, n_actions), generator=gen) < 0.5
        mask[:, int(seed % n_actions)] = True
        if rows > 2:
            mask[1] = False
        logits = torch.where(mask, 0.0, float("-inf"))
        want = TF.categorical(key, logits)
        assert torch.equal(categorical(key, logits, lib=host_lib), want)
        if rows > 2:
            assert int(want[1]) == 0


def test_ties_and_nans_follow_argmax(host_lib):
    """torch.argmax's rule on the scores: the first maximum, a NaN above
    every number (the first NaN), -inf everywhere picks 0."""
    n_actions = 40
    key = TF.key(3)
    rows = torch.zeros((4, n_actions))
    rows[0] = float("-inf")
    rows[1, [5, 33]] = float("nan")
    rows[2, 38] = float("nan")
    rows[3] = float("inf")
    got = categorical(key, rows, lib=host_lib)
    assert got.tolist() == [0, 5, 38, 0]
    assert torch.equal(got, TF.categorical(key, rows))


def test_the_cpu_path_is_the_twin():
    """Without a library, a CPU tensor takes the plain draw and counts no
    launch."""
    key = TF.key(11)
    logits = torch.randn((64, 17), generator=torch.Generator().manual_seed(1))
    before = CK.launches
    assert torch.equal(categorical(key, logits), TF.categorical(key, logits))
    assert CK.launches == before


def test_the_wrapper_checks_its_tensors(host_lib):
    key = TF.key(0)
    logits = torch.randn((4, 17))
    before = CK.launches
    assert categorical(key, logits, lib=host_lib).shape == (4,)
    assert CK.launches == before + 1
    with pytest.raises(TypeError, match="int64"):
        categorical(key.to(torch.int32), logits, lib=host_lib)
    with pytest.raises(TypeError, match="float32"):
        categorical(key, logits.double(), lib=host_lib)
    with pytest.raises(ValueError, match="shape"):
        categorical(TF.split(key, 4), logits, lib=host_lib)
    with pytest.raises(ValueError, match=r"\[B, A\]"):
        categorical(key, logits[0], lib=host_lib)
    # counters past 2^32, refused before the copy that makes them contiguous
    with pytest.raises(ValueError, match="2\\^32"):
        categorical(key, logits[:1].expand(2 ** 32 // 17 + 1, 17),
                    lib=host_lib)
    # a transposed view is made contiguous; no rows draws nothing
    wide = torch.randn((17, 4))
    assert torch.equal(categorical(key, wide.t(), lib=host_lib),
                       TF.categorical(key, wide.t().contiguous()))
    assert categorical(key, logits[:0], lib=host_lib).shape == (0,)
    # the library's refusal, past the wrapper's checks, raises
    with pytest.raises(RuntimeError, match="refused"):
        categorical(key, torch.zeros((4, 0)), lib=host_lib)


def _counts(name):
    return [(sp.counts["steps"], sp.counts["kernel_draws"])
            for sp in trace.spans() if sp.name == name]


def test_the_spans_count_the_kernel_draws(host_lib, monkeypatch):
    """Keyed evaluation and the chain's stage play with the host build in
    the kernel's place: their spans count a kernel draw a step; with the
    plain draw (the CPU's) and for random actions they count none."""
    solver = restore_checkpoint("trained_agents_torch/"
                                "NovelGridworld-Pogostick-v1_solver/"
                                "best.pt")["params"]
    stage = restore_checkpoint("trained_agents_torch/chain/"
                               "NovelGridworld-v2/best.pt")["params"]
    run = EV.make_eval(nt.make_spec("NovelGridworld-Pogostick-v1"), cap=6,
                       device="cpu")
    chains = [CUR.make_chain_reset(["NovelGridworld-v2", "NovelGridworld-v3"],
                                   [p], 8, 5, "cpu")[0]
              for p in (stage, None)]

    def host_draw(key, logits):
        return categorical(key, logits, lib=host_lib)

    for kernel in (False, True):
        if kernel:
            monkeypatch.setattr(CK, "categorical", host_draw)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            run(solver, TF.key(1), 16)
            run(None, TF.key(2), 16)
            for chain in chains:
                chain(TF.key(3))
        for name in ("ngx_torch.eval.run", "ngx_torch.chain.stage"):
            # the last profile's last two spans: the policy's, the random one's
            policy, random = _counts(name)[-2:]
            assert policy[0] > 0 and random[0] > 0
            assert policy[1] == (policy[0] if kernel else 0)
            assert random[1] == 0
