"""The CUDA kernels over ngx's whole spec domain: more than 64 and 128 item
ids (the int16 map cell, csrc/ngx_env.cuh wide_cell) and the NOOP op.

The kernels' device code built for the host with g++ (the shim of
tests/test_torch_train_rollout.py) against the plain twins on the 39-, 70-
and 140-id specs and the NOOP spec — 'input', 'prng' and the T-0 pool draw
bit for bit, the train kernel in native and pool mode and 'policy' to the
near-tie rule — the twin against ngx's Pallas kernel in interpret mode on
the 70-id spec (its replace edit alone: XLA takes minutes to compile the
kernel's 61 edits in interpret mode) and the NOOP spec, and against ngx's
plain step on the whole 70- and 140-id specs, the entries' own geometry
where a block outgrows shared memory, and the shared-memory limit that
remains (check_kernel_supported, asked of the device code's layouts).
About 57 s on one xdist worker (the tier-1 command gives a file one).
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ngx
from ngx.ops import pallas_rollout as P
import ngx_torch as nt
from ngx_torch.core import spec as S
from ngx_torch.ops import rollout as R
from ngx_torch.ops import tables as TB
from ngx_torch.ops import threefry as TF
from ngx_torch.ops import train_rollout as TR
from ngx_torch.rl.models import ActorCritic

from test_torch_rollout import _assert_state_equal
from test_torch_step import noop_specs, wide_specs
from test_torch_train_rollout import _assert_agree, build_host_lib

torch.set_num_threads(1)

B, BLOCK, T, HIDDEN = 300, 150, 24, (16, 16)


def wide_replaced(pkg, n_add, fence=False):
    """Pogostick-v1 with ``n_add`` stacked additems and the wall replaced by
    a new item, so that the last id lies on every map's border (60: 70 ids,
    64-69 on the map; 130: 140 ids, past 127); ``fence`` stacks a fence
    medium on top, whose reset edit runs over cells holding ids with bit
    6 set."""
    sp = wide_specs(pkg, n_add=n_add)
    sp = pkg.inject_novelty(sp, "replaceitem", "hard", "wall", "newwall")
    if fence:
        sp = pkg.inject_novelty(sp, "fence", "medium", "oak")
    return sp


BUILDERS = {
    "39 ids": lambda pkg: wide_specs(pkg),
    "70 ids": lambda pkg: wide_replaced(pkg, 60),
    "70 ids + fence": lambda pkg: wide_replaced(pkg, 60, fence=True),
    "140 ids": lambda pkg: wide_replaced(pkg, 130),
    "NOOP": lambda pkg: noop_specs(pkg),
}
_specs = {}


def spec(name):
    """The port's spec of ``name`` under LidarInFront, built once."""
    if name not in _specs:
        _specs[name] = nt.lidar_in_front(BUILDERS[name](nt))
    return _specs[name]


def _layers(spt, seed):
    m = ActorCritic.from_key(TF.key(seed), TB.lidar_obs_dim(spt),
                             spt.n_actions, HIDDEN)
    return [(w.detach(), b.detach()) for w, b in m.pi_layers()]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory.mktemp("host_wide"))


def test_the_specs_reach_the_wide_cell(host_lib):
    """What the cases cover: the item counts, ids past 63 and 127 on the
    reset maps (bit 6 and the int8 cell's sign), the cell the
    library picks, and NOOP."""
    counts = {n: spec(n).n_items for n in BUILDERS}
    assert counts == {"39 ids": 39, "70 ids": 70, "70 ids + fence": 71,
                      "140 ids": 140, "NOOP": 9}
    for name, low in (("70 ids", 64), ("140 ids", 128)):
        st = nt.counter_reset(spec(name), 3, 0, 64, device="cpu")
        assert int(st.map.max()) >= low and int(st.map.max()) == \
            spec(name).n_items - 1
    assert [host_lib.ngx_wide_cell(c) for c in counts.values()] == \
        [0, 1, 1, 1, 0]
    assert [host_lib.ngx_wide_cell(c) for c in (64, 65)] == [0, 1]
    assert S.OP_NOOP in np.asarray(spec("NOOP").action_op)


@pytest.mark.parametrize("source", ["input", "prng"])
@pytest.mark.parametrize("name", list(BUILDERS))
def test_warp_modes_match_twin(host_lib, name, source):
    """'input' and 'prng' through the warp's phases (B 300, blocks of 150, a
    ragged last warp) bit for bit against the twin: every state field, the
    reward sums and the done counts; 'prng' at T 0 too, the trainer's pool
    draw."""
    spt = spec(name)
    acts = None
    if source == "input":
        acts = torch.as_tensor(np.random.RandomState(5).randint(
            spt.n_actions, size=(T, B)), dtype=torch.int32)
    cpu = torch.device("cpu")
    for steps in ((T, 0) if source == "prng" else (T,)):
        a = acts if source == "input" else None
        got = R.launch(host_lib, spt, B, steps, -71, BLOCK, source, a, None,
                       cpu, None)
        want = R.rollout_plain(spt, B, steps, -71, BLOCK, source, a,
                               device=cpu)
        _assert_state_equal(want[0], got[0])
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("mode", ["native", "pool"])
@pytest.mark.parametrize("name", list(BUILDERS))
def test_train_kernel_matches_twin(host_lib, name, mode):
    """The train kernel from the same state, weights and seed as its twin,
    cap 6 so every env ends episodes: native resets (warp_reset in the
    tile's reset phase, the fence edit over ids with bit 6 set on the 70-id
    fence case) or pool restores
    (R 2, the pool drawn by the twin's T-0 draw), to the near-tie rule."""
    spt = spec(name)
    b, cap, seed, block = 256, 6, 2 ** 31 - 9, 128
    st = nt.counter_reset(spt, 4, 0, b, device="cpu")
    st = st.replace(step_count=torch.as_tensor(
        np.random.RandomState(1).randint(0, cap, b), dtype=torch.int32))
    layers = _layers(spt, 11)
    kw = {}
    if mode == "pool":
        kw = dict(pool=R.pool_reset(spt, 2 * b, 17, device="cpu"),
                  base=torch.as_tensor(np.random.RandomState(2).randint(
                      0, 3, b), dtype=torch.int32))
    got = TR.launch(host_lib, spt, st, layers, seed, T, block, cap, None,
                    **kw)
    want = TR.train_rollout_plain(spt, st, layers, seed, T, block, cap, **kw)
    _assert_agree(want, got, layers, seed, block)
    assert int(want[4].sum()) >= b * (T // cap - 1)


@pytest.mark.parametrize("name", ["39 ids", "70 ids", "140 ids", "NOOP"])
def test_policy_mode_matches_twin(host_lib, name):
    """'policy' (the tile MLP, the most envs a tile that fit) against the
    twin, as test_device_code_matches_twin holds it: at most 1% of envs
    differ, at Gumbel near-ties."""
    spt = spec(name)
    layers = _layers(spt, 3)
    cpu = torch.device("cpu")
    got = R.launch(host_lib, spt, 256, T, 12, 128, "policy", None, layers,
                   cpu, None)
    want = R.rollout_plain(spt, 256, T, 12, 128, "policy", None, layers,
                           cpu)
    same = torch.ones(256, dtype=torch.bool)
    for k, v in want[0].to_numpy().items():
        g = got[0].to_numpy()[k]
        same &= torch.as_tensor((g == v).reshape(256, -1).all(1))
    same &= (got[1] == want[1]) & (got[2] == want[2])
    assert int((~same).sum()) <= 0.01 * 256


def _replace_only(sp):
    """``sp`` with its reset edits but the last (the 70-id spec's wall
    replacement) left out: every item id in the tables and the lidar, the
    last id on every border, one edit for XLA to compile."""
    return sp.replace(reset_edits=sp.reset_edits[-1:])


@pytest.mark.parametrize("name", ["70 ids", "NOOP"])
def test_twin_matches_pallas(name):
    """The twin's 'input' mode against ngx's Pallas kernel in interpret
    mode (as tests/test_torch_rollout.py's test_input_mode_matches_pallas):
    the final state bit for bit, the done count, the mean reward.  On the
    70-id spec, its wall replacement alone (:func:`_replace_only`); the
    whole spec is held against ngx's plain step below."""
    sp, spt = nt_pair(name)
    if name == "70 ids":
        sp, spt = _replace_only(sp), _replace_only(spt)
        assert spt.n_items == 70 and len(spt.reset_edits) == 1
    b, steps, block, seed = 64, 16, 32, 9
    acts = np.random.RandomState(4).randint(sp.n_actions, size=(steps, b))
    acts = acts.astype(np.int32)
    run = P.make_pallas_rollout(sp, b, steps, block=block,
                                action_source="input", interpret=True)
    st, mean_j, n_j = jax.jit(run)(seed, jnp.asarray(acts))
    state, mean_t, n_t = R.make_rollout(spt, b, steps, block=block,
                                        action_source="input",
                                        device="cpu")(seed,
                                                      torch.as_tensor(acts))
    _assert_state_equal(st, state)
    assert int(state.map.max()) == 69 if name == "70 ids" else True
    assert int(n_j) == int(n_t)
    np.testing.assert_allclose(float(mean_t), float(mean_j), rtol=1e-6)


def nt_pair(name):
    """ngx's spec of ``name`` under LidarInFront, and the port's."""
    return ngx.transforms.lidar_in_front(BUILDERS[name](ngx)), spec(name)


@pytest.mark.parametrize("name", ["70 ids", "140 ids"])
def test_twin_matches_ngx_plain_step(name):
    """The whole 70- and 140-id specs (61 and 131 reset edits): the twin's
    'input' run against ngx's plain step — ngx's counter reset
    (make_xla_pool_reset, one RNG block) then its vmapped step on the same
    actions — the final state bit for bit."""
    sp, spt = nt_pair(name)
    b, steps, seed = 32, 12, 6
    acts = np.random.RandomState(8).randint(sp.n_actions, size=(steps, b))
    st = P.make_xla_pool_reset(sp, b)(seed, 0)
    st = st.replace(last_done=st.last_done.astype(bool))
    step = jax.jit(jax.vmap(ngx.make_step(sp)))
    for t in range(steps):
        st, _, _, done, _ = step(st, jnp.asarray(acts[t], jnp.int32))
        assert not bool(done.any())        # no reset to replay
    state, _, dcount = R.rollout_plain(
        spt, b, steps, seed, b, "input",
        torch.as_tensor(acts.astype(np.int32)), device=torch.device("cpu"))
    assert int(dcount.sum()) == 0 and int(state.map.max()) >= 64
    _assert_state_equal(st, state)


def _smem_case(name):
    spt = spec(name)
    return spt, TB.kernel_tables(spt), spt.map_size ** 2, spt.n_items


# does a block of 256 threads (8 warps) and a train tile of 32 envs at
# hidden (64, 64) fit the card's shared memory?
FITS = {"39 ids": (True, True), "70 ids": (True, False),
        "70 ids + fence": (True, False), "140 ids": (True, False),
        "NOOP": (True, True)}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_entries_pick_a_geometry_that_fits(host_lib, name):
    """The library's queries (ngx_rollout_smem, ngx_tile_smem) give a
    block's bytes within the budget where it fits and, negated, more than
    the budget where it does not (the wide train tiles of 32 envs, which
    the entry halves: test_train_kernel_matches_twin); and the geometry
    changes no result: 'prng' at one warp a block equals the default's
    bit for bit."""
    spt, tab, hw, ni = _smem_case(name)
    budget = host_lib.ngx_smem_optin()
    edits = TB.has_novelty(spt) and bool(spt.reset_edits)
    warp = host_lib.ngx_rollout_smem(tab.size, hw, ni, int(edits), 256,
                                     ctypes.byref(ctypes.c_int(1)))
    dims = [TB.lidar_obs_dim(spt), 64, 64, spt.n_actions]
    tile = host_lib.ngx_tile_smem(TB.kernel_tables(spt, dims).size,
                                  TB.c_ints(dims), len(dims), 32, hw, ni, 1)
    for size in (warp, tile):
        assert 0 < size <= budget or -size > budget
    assert (warp > 0, tile > 0) == FITS[name]
    cpu = torch.device("cpu")
    one, dflt = (R.launch(host_lib, spt, B, T, 5, BLOCK, "prng", None, None,
                          cpu, None, threads=n) for n in (32, None))
    _assert_state_equal(one[0], dflt[0])
    assert torch.equal(one[1], dflt[1]) and torch.equal(one[2], dflt[2])


def test_check_kernel_supported_refuses_past_shared_memory(host_lib):
    """The one limit left: a spec whose smallest train tile (4 envs)
    outgrows the card's opt-in shared memory — 410 item ids, an obs 3,671
    wide — is refused with the library's layouts, the message naming the
    bytes and the budget, by check_kernel_supported and by the train
    kernel's launch; its warps still fit, and 'prng' asked for 8 a block
    runs on the fewer that the entry picks.  Without a library only the
    plain path's gates apply.  The 140-id spec passes, with its hidden
    widths too."""
    wide = spec("140 ids")
    nt.check_kernel_supported(wide, None, host_lib)
    nt.check_kernel_supported(wide, [TB.lidar_obs_dim(wide), 64, 64,
                                     wide.n_actions], host_lib)
    big = nt.lidar_in_front(wide_replaced(nt, 400))
    hw, ni = big.map_size ** 2, big.n_items
    dims = [TB.lidar_obs_dim(big), big.n_actions]
    assert dims[0] == 3671
    budget = host_lib.ngx_smem_optin()
    need = -host_lib.ngx_tile_smem(TB.kernel_tables(big, dims).size,
                                   TB.c_ints(dims), len(dims), 4, hw, ni, 1)
    assert need > budget == 232448
    with pytest.raises(NotImplementedError,
                       match=f"needs {need} bytes .*{budget} bytes"):
        nt.check_kernel_supported(big, dims, host_lib)
    nt.check_kernel_supported(big, dims)
    nt.check_kernel_supported(big, None, host_lib)
    layers = [(torch.zeros(big.n_actions, dims[0]),
               torch.zeros(big.n_actions))]
    st = nt.counter_reset(big, 1, 0, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="shared memory"):
        TR.launch(host_lib, big, st, layers, 0, 1, 32, 10, None)
    # its warps fit one or two a block, not 8: the entry halves them
    n_tab = TB.kernel_tables(big).size
    assert [host_lib.ngx_rollout_smem(n_tab, hw, ni, 1, n,
                                      ctypes.byref(ctypes.c_int(1))) > 0
            for n in (32, 64, 256)] == [True, True, False]
    cpu = torch.device("cpu")
    got = [R.launch(host_lib, big, 64, 2, 3, 32, "prng", None, None, cpu,
                    None, threads=n) for n in (256, 32)]
    _assert_state_equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])


def test_kernel_ab_pairs_instantiations_across_versions(monkeypatch):
    """-mode sass pairs each kernel of a later checkout with the first
    checkout's of the same instantiation — a parent that does not name the
    map cell against a tree that names the int8 one (``signed char``) —
    says whether its counts and ptxas lines are equal (the counts alone
    for a library built before, whose build printed no ptxas lines), and
    lists the wide (``short``) instantiations as new."""
    import json
    import types

    from ngx_torch.cli import kernel_ab
    from ngx_torch.ops import _build

    libs = {"parent": {"_Za": (100, 3)},
            "tree": {"_Zb": (100, 3), "_Zc": (90, 2), "_Zd": (140, 5)},
            "built": {"_Zb": (100, 3)}}
    names = {"_Za": "void rollout_kernel<false, 0>(EnvRolloutArgs, SpecHdr)",
             "_Zb": "void rollout_kernel<false, 0, signed char>"
                    "(EnvRolloutArgs, SpecHdr)",
             "_Zc": "void rollout_kernel<true, 0, signed char>"
                    "(EnvRolloutArgs, SpecHdr)",
             "_Zd": "void rollout_kernel<false, 0, short>"
                    "(EnvRolloutArgs, SpecHdr)"}
    log = "ptxas info    : Compiling entry function '{}' for 'sm_90a'\n" \
          "ptxas info    : Used 64 registers\n"

    def run(argv, cwd, **kw):
        # a library already built prints no ptxas log
        body = "" if cwd == "built" else "".join(log.format(m)
                                                 for m in libs[cwd])
        return types.SimpleNamespace(returncode=0, stderr="", stdout=json.dumps(
            {"lib": cwd, "seconds": 1.5, "log": body}))

    monkeypatch.setattr(kernel_ab.subprocess, "run", run)
    monkeypatch.setattr(_build, "sass_counts", lambda lib: libs[str(lib)])
    monkeypatch.setattr(_build, "demangle", lambda ms: [names[m] for m in ms])
    rows = kernel_ab.sass_report(["parent", "tree", "built"])
    tree = {r["kernel"]: r for r in rows if r["dir"] == "tree"}
    assert [(r["same"], r["wide"]) for r in tree.values()] == [
        (True, False), (None, False), (None, True)]
    # its counts equal the parent's: equal, though ptxas printed nothing
    assert [r["same"] for r in rows if r["dir"] == "built"] == [True]
    assert kernel_ab.instantiation(names["_Zb"]) == names["_Za"]
