"""ngx's native reset on the port, from ngx's keys (ngx_torch/core/reset.py
``make_reset``), bit for bit against ``jax.vmap(ngx.make_reset)`` on the
CPU, and ngx's last public names, ``zeros_state`` and ``make_lidar_fn``.
The env-stepping scan on the same keys is tests/test_torch_threefry_scan.py
(one file each keeps both under a minute)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

import ngx
import ngx_torch as nt
from ngx_torch.core.state import EnvState, zeros_state
from ngx_torch.ops import threefry as TF
from ngx_torch.ops.rays import make_lidar_fn
from ngx_torch.utils import debug

from test_torch_spec import NOVELTIES, STACKED, novelty_specs

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

B = 64
PRESETS = (
    "NovelGridworld-v0", "NovelGridworld-v1", "NovelGridworld-v2",
    "NovelGridworld-v3", "NovelGridworld-v4", "NovelGridworld-v5",
    "NovelGridworld-v6", "NovelGridworld-Bow-v0", "NovelGridworld-Bow-v1",
    "NovelGridworld-Pogostick-v0", "NovelGridworld-Pogostick-v1")
POGO = "NovelGridworld-Pogostick-v1"
# the 11 presets, the 13 novelties (tests/test_torch_spec.py) and a stack
# of two
CASES = ([(e, ()) for e in PRESETS] + [(e, (n,)) for e, n in NOVELTIES]
         + [STACKED])


def _specs(env_id, novs):
    return novelty_specs(ngx, env_id, novs), novelty_specs(nt, env_id, novs)


def _keys(seed, n=B):
    kj = jax.random.split(jax.random.key(seed), n)
    return kj, torch.as_tensor(np.array(jax.random.key_data(kj)),
                               dtype=torch.int64)


@pytest.fixture(scope="module")
def ngx_resets():
    """ngx's batched reset of every case, compiled once for ``B`` keys;
    XLA compiles four at a time (its compiler releases the GIL), which
    halves the file's time."""
    kj = _keys(0)[0]

    def build(case):
        reset = jax.jit(jax.vmap(ngx.make_reset(_specs(*case)[0])))
        return case, reset.lower(kj).compile()

    with ThreadPoolExecutor(4) as pool:
        return dict(pool.map(build, CASES))


def _rows_differing(want, got):
    """The count of envs whose state differs in any field, and the fields."""
    bad, fields = np.zeros(got.batch, bool), []
    for f, v in got.to_numpy().items():
        w = np.asarray(getattr(want, f))
        assert w.dtype == v.dtype, f
        diff = (w.reshape(len(w), -1) != v.reshape(len(v), -1)).any(1)
        if diff.any():
            fields.append(f)
        bad |= diff
    return int(bad.sum()), fields


def _assert_obs_equal(want, got):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(),
                                          err_msg=k)
    else:
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("env_id,novs", CASES,
                         ids=[f"{e}-{'+'.join(n[0] for n in v) or 'plain'}"
                              for e, v in CASES])
def test_native_reset_matches_ngx(ngx_resets, env_id, novs):
    """The 11 presets, the 13 novelties and a stack of two: state and obs of
    ``nt.make_reset(spec, device='cpu')(keys)`` equal to
    ``jax.vmap(ngx.make_reset(spec))(keys)`` on every env of 64."""
    spt = _specs(env_id, novs)[1]
    kj, kt = _keys(len(env_id) * 7 + len(novs))
    want_s, want_o = ngx_resets[env_id, novs](kj)
    got_s, got_o = nt.make_reset(spt, device="cpu")(kt)
    n, fields = _rows_differing(want_s, got_s)
    assert n == 0, f"{n} of {B} envs differ from ngx's in {fields}"
    _assert_obs_equal(want_o, got_o)


def test_make_reset_defaults_to_the_card_and_checks_under_debug(monkeypatch):
    """No device named: the card, or an error where there is none.  Built
    under ``NGX_DEBUG=1`` each reset runs the invariant asserts, as ngx's
    hook does; keys must be ``[B, 2]``."""
    spec = nt.make_spec(POGO)
    if torch.cuda.is_available():
        assert nt.make_reset(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            nt.make_reset(spec)
    seen = []
    monkeypatch.setenv("NGX_DEBUG", "1")
    monkeypatch.setattr(debug, "kernel_asserts",
                        lambda sp, st, where: seen.append((where, st.batch)))
    reset = nt.make_reset(spec, device="cpu")
    reset(_keys(1, 3)[1])
    assert seen == [("reset", 3)]
    with pytest.raises(ValueError, match=r"\[B, 2\]"):
        reset(TF.key(1))


def test_zeros_state_matches_ngx():
    for env_id in (POGO, "NovelGridworld-v1"):
        spj, spt = ngx.make_spec(env_id), nt.make_spec(env_id)
        want = ngx.core.state.zeros_state(spj)
        got = zeros_state(spt, device="cpu")
        assert got.batch == 1
        for f, v in got.to_numpy().items():
            w = np.asarray(getattr(want, f))
            assert v.dtype == w.dtype, f
            np.testing.assert_array_equal(v[0], w, err_msg=f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            zeros_state(nt.make_spec(POGO))


@pytest.mark.parametrize("env_id", ["NovelGridworld-v0", "NovelGridworld-v1",
                                    POGO])
def test_make_lidar_fn_matches_ngx(ngx_resets, env_id):
    """ngx's name for ``make_lidar``: the V0 lidar (v0), the INV lidar
    (v1) and LidarInFront (Pogostick-v1), batched, against ngx's per-env
    lidar under ``jax.vmap`` on states of ngx's reset."""
    spj, spt = ngx.make_spec(env_id), nt.make_spec(env_id)
    if env_id == POGO:
        spj = ngx.transforms.lidar_in_front(spj)
        spt = nt.lidar_in_front(spt)
    # the states of ngx's reset (LidarInFront changes only the obs)
    st, _ = ngx_resets[env_id, ()](_keys(5)[0])
    lid_j, lid_t = ngx.ops.rays.make_lidar_fn(spj), make_lidar_fn(spt)
    want = jax.jit(jax.vmap(lid_j))(st.map, st.agent, st.facing)
    s = EnvState.from_ngx(st)
    got = lid_t(s.map, s.agent, s.facing)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert (lid_t.n_slots, lid_t.num_beams) == (lid_j.n_slots,
                                               lid_j.num_beams)
