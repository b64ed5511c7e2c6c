"""The native reset kernel's device code (ngx_torch/ops/csrc/native_reset.cuh)
built for the host with g++, through the wrapper's launch path
(ngx_torch/ops/native_reset.py), against the plain twin
(ngx_torch/core/reset.py ``native_reset_plain`` and ``native_reset_where``),
bit for bit on every row: explicit keys, and a step's carried state on a
parent key and a row offset (a mixed mask, every row done, none done) and
on explicit keys.  The plain twin itself is held against ngx in
tests/test_torch_native_reset.py.  About 20 s alone, the g++ build included."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import ngx_torch as nt
from ngx_torch.core.reset import (ResetTables, native_reset_plain,
                                  native_reset_where)
from ngx_torch.ops import threefry as TF
from ngx_torch.ops._build import CSRC, declare_native_reset
from ngx_torch.ops.native_reset import native_reset

from test_torch_native_reset import CASES
from test_torch_spec import novelty_specs

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

B = 64
IDS = [f"{e}-{'+'.join(n[0] for n in v) or 'plain'}" for e, v in CASES]

# ngx_native_reset on the host: the kernel's rows in turn, each on a
# HostWarp (a phase runs the 32 lanes in order, the collectives are loops)
# over the kernel's shared-memory layout of one row
HOST_SHIM = r"""
#include "native_reset.cuh"
#include <vector>

extern "C" int ngx_native_reset(const int* tab, int n, int hw, int n_items,
                                const long long* keys, const long long* parent,
                                long long offset, const unsigned char* done,
                                void* const* in, void* const* out, void*) {
  if (!tab || n < 1 || hw < 1 || n_items < 0 || !out || (!keys && !parent) ||
      (done && !in))
    return 1;
  NativeResetArgs p = {tab,  n,      hw, n_items, keys, parent, offset, done,
                       done ? state_rows(in) : StateRows{}, state_rows(out)};
  std::vector<unsigned char> smem(native_reset_row_bytes(hw));
  Key* ks = reinterpret_cast<Key*>(smem.data());
  int* m = reinterpret_cast<int*>(smem.data() + (size_t)hw * sizeof(Key));
  const HostWarp w;
  for (long long row = 0; row < n; ++row) native_reset_row(w, p, row, m, ks);
  return 0;
}

extern "C" const char* ngx_error_string(int) { return "refused"; }
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's device code for the host")
    d = tmp_path_factory.mktemp("native_reset")
    (d / "shim.cpp").write_text(HOST_SHIM)
    so = d / "libhost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    str(CSRC), "-o", str(so), str(d / "shim.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = declare_native_reset(ctypes.CDLL(str(so)))
    lib.ngx_error_string.argtypes = [ctypes.c_int]
    lib.ngx_error_string.restype = ctypes.c_char_p
    return lib


def _assert_same(want, got):
    for f, w in want.to_numpy().items():
        g = getattr(got, f).numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, f
        bad = (w.reshape(len(w), -1) != g.reshape(len(g), -1)).any(1)
        assert not bad.any(), f"{f}: rows {np.nonzero(bad)[0][:8]} differ"


def _stepped(tab, seed):
    """A batch of ``B`` states standing in for a step's: reset states with
    every register leaf set apart from a fresh env's, so a copied row
    shows."""
    st = native_reset_plain(tab, TF.split(TF.key(seed), B))
    g = torch.Generator().manual_seed(seed)
    i32 = torch.int32
    return st.replace(
        selected=torch.randint(-1, 3, (B,), generator=g, dtype=i32),
        step_count=torch.randint(1, 100, (B,), generator=g, dtype=i32),
        last_action=torch.randint(0, 5, (B,), generator=g, dtype=i32),
        last_reward=torch.rand((B,), generator=g) - 0.5,
        last_cost=torch.rand((B,), generator=g),
        last_done=torch.rand((B,), generator=g) < 0.5)


@pytest.mark.parametrize("env_id,novs", CASES, ids=IDS)
def test_kernel_device_code_matches_the_twin_on_keys(host_lib, env_id,
                                                    novs):
    """Explicit keys: every row of every leaf equal to the plain reset's."""
    sp = novelty_specs(nt, env_id, novs)
    keys = TF.split(TF.key(len(env_id) * 13 + len(novs)), B)
    want = native_reset_plain(ResetTables(sp), keys)
    _assert_same(want, native_reset(sp, keys, lib=host_lib))


@pytest.mark.parametrize("env_id,novs", CASES, ids=IDS)
def test_kernel_device_code_matches_the_twin_on_a_done_mask(host_lib, env_id,
                                                           novs):
    """A step's carried state: a mixed mask on a parent key with a row
    offset, every row done, no row done, and a mixed mask on explicit
    keys; the done rows equal the reset of their keys, the others are
    the stepped rows, unchanged."""
    sp = novelty_specs(nt, env_id, novs)
    tab = ResetTables(sp)
    state = _stepped(tab, len(env_id) + 5)
    parent = TF.fold_in(TF.key(31), len(novs))
    mixed = torch.rand((B,), generator=torch.Generator().manual_seed(3)) < 0.4
    masks = {"mixed": mixed, "all": torch.ones((B,), dtype=torch.bool),
             "none": torch.zeros((B,), dtype=torch.bool)}
    for name, done in masks.items():
        offset = 3 * B + 7 if name == "mixed" else 0
        want = native_reset_where(tab, state, done, parent=parent,
                                  offset=offset)
        got = native_reset(sp, parent=parent, offset=offset, state=state,
                           done=done, lib=host_lib)
        _assert_same(want, got)
        fresh = native_reset_plain(
            tab, TF.split_at(parent, torch.arange(B) + offset))
        for f, v in got.to_numpy().items():
            keep = np.asarray(getattr(state, f).numpy())
            new = np.asarray(getattr(fresh, f).numpy())
            m = done.numpy().reshape((B,) + (1,) * (v.ndim - 1))
            np.testing.assert_array_equal(v, np.where(m, new, keep), err_msg=f)
    keys = TF.split(TF.key(77), B)
    _assert_same(native_reset_where(tab, state, mixed, keys=keys),
                 native_reset(sp, keys, state=state, done=mixed,
                              lib=host_lib))


def test_the_wrapper_checks_its_tensors(host_lib):
    sp = nt.make_spec("NovelGridworld-Pogostick-v1")
    keys = TF.split(TF.key(0), 4)
    with pytest.raises(TypeError, match="int64"):
        native_reset(sp, keys.to(torch.int32), lib=host_lib)
    with pytest.raises(ValueError, match="shape"):
        native_reset(sp, keys[:, :1], lib=host_lib)
    with pytest.raises(ValueError, match="takes keys"):
        native_reset(sp, lib=host_lib)
    state = native_reset(sp, keys, lib=host_lib)
    with pytest.raises(TypeError, match="torch.bool"):
        native_reset(sp, parent=TF.key(1), state=state,
                     done=torch.zeros((4,), dtype=torch.int32), lib=host_lib)
    assert native_reset(sp, keys[:0], lib=host_lib).batch == 0
