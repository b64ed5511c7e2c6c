"""The env-stepping ablations and the state packers against ngx on the CPU:
make_state_packers (ngx_torch/core/state.py) word for word against
ngx.core.state's, the 'hash' and 'fixed' actions and auto_reset=False
against ngx's own throughput_fn, and every ablation of the rollout kernel's
device code (built for the host with g++) against its plain twin."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ngx
from ngx.core.state import make_state_packers as ngx_packers
from ngx.vector import throughput_fn as ngx_throughput_fn
import ngx_torch as nt
from ngx_torch.core.state import EnvState, make_state_packers
from ngx_torch.ops import rollout as R
from ngx_torch.vector import hash_actions, throughput_fn

from test_torch_spec import novelty_specs
from test_torch_train_rollout import build_host_lib

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

POGO = "NovelGridworld-Pogostick-v1"
PACK_SPECS = [(POGO, ()), ("NovelGridworld-v3", ()),
              ("NovelGridworld-Bow-v0", ()), (POGO, (("fence", "medium",
                                                      "oak"),))]
ABLATIONS = [dict(action_rng="hash"), dict(action_rng="fixed"),
             dict(auto_reset=False), dict(packed=True)]


def _assert_state_equal(want, got: EnvState):
    """Every leaf of ``want`` (ngx's or the port's) equals ``got``'s."""
    if isinstance(want, EnvState):
        want = want.to_numpy()
    else:
        want = {k: np.asarray(getattr(want, k)) for k in got.to_numpy()}
    for k, v in got.to_numpy().items():
        np.testing.assert_array_equal(want[k].reshape(v.shape), v, err_msg=k)


def _ngx_states(sp, n, seed):
    """``n`` reset states of ngx's ``sp`` with every scalar field drawn at
    random in its range (so each bit field of the packing is exercised),
    as a numpy dict of ngx's leaves."""
    st, _ = jax.vmap(ngx.make_reset(sp))(jax.random.split(
        jax.random.key(seed), n))
    st = {k: np.array(getattr(st, k)) for k in EnvState.__dataclass_fields__}
    rs = np.random.RandomState(seed)
    st["selected"] = rs.randint(-1, sp.n_items, n).astype(np.int32)
    st["step_count"] = rs.randint(0, 2 ** 31 - 1, n).astype(np.int32)
    st["last_action"] = rs.randint(0, sp.n_actions, n).astype(np.int32)
    st["last_reward"] = rs.randn(n).astype(np.float32) * 50
    st["last_cost"] = -rs.rand(n).astype(np.float32)
    st["last_done"] = rs.rand(n) < 0.5
    st["inventory"] = rs.randint(0, 300, st["inventory"].shape).astype(
        np.int32)
    return st


@pytest.mark.parametrize("env_id,novs", PACK_SPECS)
def test_state_packers_match_ngx(env_id, novs):
    """pack's words are ngx's pack's, bit for bit; unpack(pack(s)) == s;
    ngx's word count (26 on Pogostick-v1)."""
    sp, spt = novelty_specs(ngx, env_id, novs), novelty_specs(nt, env_id, novs)
    st = _ngx_states(sp, 96, 7)
    pack_j, unpack_j, n_j = ngx_packers(sp)
    pack_t, unpack_t, n_t = make_state_packers(spt)
    words_j = np.asarray(pack_j(ngx.EnvState(**{k: jnp.asarray(v)
                                                for k, v in st.items()})))
    state = EnvState.from_ngx(SimpleNamespace(**st))
    words_t = pack_t(state)
    assert n_t == n_j and words_t.shape == (96, n_t)
    assert words_t.dtype == torch.int32
    np.testing.assert_array_equal(words_t.numpy(), words_j)
    back = unpack_t(words_t)
    _assert_state_equal(state, back)
    _assert_state_equal(unpack_j(jnp.asarray(words_j)), back)
    if env_id == POGO and not novs:
        assert n_t == 26


def test_state_packers_keep_ngx_missing_inventory_guard():
    """A count of 32,768 or more spills into its neighbour's 15 bits, as in
    ngx (no width guard): the same words, and unpack gives what ngx's
    unpack gives, not the count."""
    sp, spt = ngx.make_spec(POGO), nt.make_spec(POGO)
    st = _ngx_states(sp, 8, 3)
    st["inventory"][:, 0] = [0, 32767, 32768, 40000, 65535, 65536, 70001,
                             2 ** 20]
    st["inventory"][:, 1] = [5, 5, 5, 0, 1, 7, 0, 3]
    pack_j, unpack_j, _ = ngx_packers(sp)
    pack_t, unpack_t, _ = make_state_packers(spt)
    words_j = np.asarray(pack_j(ngx.EnvState(**{k: jnp.asarray(v)
                                                for k, v in st.items()})))
    words_t = pack_t(EnvState.from_ngx(SimpleNamespace(**st)))
    np.testing.assert_array_equal(words_t.numpy(), words_j)
    back = unpack_t(words_t)
    _assert_state_equal(unpack_j(jnp.asarray(words_j)), back)
    assert int(back.inventory[2, 0]) == 0          # 32,768 reads back as 0
    assert int(back.inventory[1, 0]) == 32767      # below the width: exact


def test_hash_actions_are_ngx_hash():
    """ngx's _hash_actions(t): the global env index and the 0-based step."""
    B, A = 1000, 17
    sp = ngx.make_spec(POGO)
    for t in (0, 1, 63, 1023, 2 ** 20):
        b = jnp.arange(B, dtype=jnp.uint32)
        x = b * jnp.uint32(0x9E3779B1) ^ (jnp.uint32(t) * jnp.uint32(
            0x85EBCA6B))
        x = x ^ (x >> 16)
        x = x * jnp.uint32(0x85EBCA6B)
        x = x ^ (x >> 13)
        x = x * jnp.uint32(0xC2B2AE35)
        x = x ^ (x >> 16)
        want = np.asarray(((x >> 1).astype(jnp.int32)) % A)
        np.testing.assert_array_equal(hash_actions(B, t, A).numpy(), want)
    assert sp.n_actions == A


@pytest.mark.parametrize("env_id,action_rng", [
    (POGO, "hash"), (POGO, "fixed"), ("NovelGridworld-v3", "hash"),
    ("NovelGridworld-Bow-v0", "fixed")])
def test_no_reset_ablations_match_ngx_throughput_fn(env_id, action_rng):
    """ngx's throughput_fn(spec, B, T, action_rng, auto_reset=False) with
    its key schedule replayed (k0, k1 = split(key); the start state
    vmap(reset)(split(k0, B))): the port's step from that state with the
    port's actions ends in ngx's final state bit for bit, and its mean
    reward is within 1e-6."""
    B, T = 64, 48
    sp, spt = ngx.make_spec(env_id), nt.make_spec(env_id)
    key = jax.random.key(11)
    st_j, mean_j = ngx_throughput_fn(sp, B, T, action_rng=action_rng,
                                     auto_reset=False)(key)
    k0, _ = jax.random.split(key)
    start, _ = jax.vmap(ngx.make_reset(sp))(jax.random.split(k0, B))
    state = EnvState.from_ngx(start)
    step = nt.make_step(spt, with_obs=False)
    r_sum, n_done = torch.zeros(()), 0
    for t in range(T):
        a = (hash_actions(B, t, spt.n_actions) if action_rng == "hash"
             else torch.zeros(B, dtype=torch.int64))
        state, _, r, done, _ = step(state, a)
        r_sum, n_done = r_sum + r.sum(), n_done + int(done.sum())
    _assert_state_equal(st_j, state)
    np.testing.assert_allclose(float(r_sum / (B * T)), float(mean_j),
                               rtol=1e-6, atol=1e-7)
    if env_id == "NovelGridworld-v3":
        assert n_done > 0          # terminal states stepped on


def test_throughput_fn_refuses_threefry_and_two_ablations():
    """The rollout kernel has no threefry variant: ``throughput_fn``'s
    'threefry' is plain torch (tests/test_torch_native_reset.py), and the
    kernel's entry refuses it; an unknown draw and two ablations at once
    are refused."""
    spec = nt.make_spec(POGO)
    with pytest.raises(ValueError, match="counter"):
        R.make_rollout(spec, 64, 2, block=64, action_rng="threefry",
                       device="cpu")
    with pytest.raises(ValueError, match="threefry"):
        throughput_fn(spec, 64, 2, action_rng="philox", device="cpu")
    with pytest.raises(ValueError, match="one at a time"):
        throughput_fn(spec, 64, 2, action_rng="hash", auto_reset=False,
                      device="cpu")
    with pytest.raises(ValueError, match="one at a time"):
        R.rollout(spec, 64, 2, 0, 64, "input", torch.zeros(
            (2, 64), dtype=torch.int32), packed=True, device="cpu")
    assert R.variant("prng", packed=True) == "prng:packed"
    assert R.variant("prng", auto_reset=False) == "prng:no-reset"
    assert set(R.rollout.launches) == set(R.VARIANTS)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory.mktemp("host_ablations"))


@pytest.mark.parametrize("ablation", ABLATIONS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
@pytest.mark.parametrize("env_id,novs", [
    (POGO, ()), ("NovelGridworld-v3", ()), (POGO, (("firewall", "hard"),))])
def test_ablation_device_code_matches_twin(host_lib, env_id, novs, ablation,
                                           monkeypatch):
    """Each ablation's variant of rollout.cu's warp rollout (g++ build)
    against rollout_plain with the same arguments, bit for bit (a ragged
    last warp: B 300 in blocks of 150); packed=True is packed=False's
    result, and the kernel's words are make_state_packers' pack of it."""
    spt = novelty_specs(nt, env_id, novs)
    batch, steps, block, seed = 300, 40, 150, -31
    dev = torch.device("cpu")
    words = []
    if ablation.get("packed"):
        real = R.make_state_packers

        def capture(sp):
            pack, unpack, n = real(sp)
            return pack, lambda w: (words.append(w.clone()), unpack(w))[1], n

        monkeypatch.setattr(R, "make_state_packers", capture)
    got = R.launch(host_lib, spt, batch, steps, seed, block, "prng", None,
                   None, dev, None, **ablation)
    monkeypatch.undo()
    want = R.rollout_plain(spt, batch, steps, seed, block, "prng",
                           device=dev, **ablation)
    _assert_state_equal(want[0], got[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    if env_id != POGO or novs:
        assert int(want[2].sum()) > 0          # episode ends on the path
    if ablation.get("packed"):
        plain = R.rollout_plain(spt, batch, steps, seed, block, "prng",
                                device=dev)
        _assert_state_equal(plain[0], got[0])
        assert torch.equal(words[0], make_state_packers(spt)[0](plain[0]))


def test_host_build_refuses_what_is_not_instantiated(host_lib):
    """The C entry point checks the combination itself (warp_variant)."""
    spt = nt.make_spec(POGO)
    with pytest.raises(RuntimeError, match="launch failed"):
        R.launch(host_lib, spt, 64, 4, 0, 64, "prng", None, None,
                 torch.device("cpu"), None, action_rng="hash",
                 auto_reset=False)
