"""The port's numpy spec layer (ngx_torch/core/spec.py, presets, the
LidarInFront rewrite) against ngx's, and the port's independence from jax."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ngx
import ngx_torch as nt

SUPPORTED = tuple(ngx.SPEC_BUILDERS)     # all 11 reference ids
REPO = Path(__file__).resolve().parents[1]


def assert_same_spec(a, b):
    fa = [f.name for f in dataclasses.fields(a)]
    assert fa == [f.name for f in dataclasses.fields(b)]
    for name in fa:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.asarray(x).dtype == np.asarray(y).dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name
    assert a.key == b.key


@pytest.mark.parametrize("env_id", SUPPORTED)
def test_presets_match_ngx(env_id):
    assert_same_spec(nt.make_spec(env_id), ngx.make_spec(env_id))
    assert_same_spec(nt.lidar_in_front(nt.make_spec(env_id)),
                     ngx.transforms.lidar_in_front(ngx.make_spec(env_id)))
    nt.check_supported(nt.lidar_in_front(nt.make_spec(env_id)))
    assert_same_spec(nt.agent_map(nt.make_spec(env_id)),
                     ngx.transforms.agent_map(ngx.make_spec(env_id)))
    nt.check_supported(nt.make_spec(env_id))
    nt.check_supported(nt.agent_map(nt.make_spec(env_id)))


def test_unported_ids_raise():
    """No reference id is left unported: the port's registry is ngx's, and
    an unknown id still raises."""
    assert sorted(nt.SPEC_BUILDERS) == sorted(ngx.SPEC_BUILDERS)
    for env_id in ngx.SPEC_BUILDERS:
        nt.check_supported(ngx.make_spec(env_id))
    with pytest.raises(KeyError):
        nt.make_spec("NovelGridworld-v99")


# one case of each of the 13 novelties (env, inject_novelty arguments); the
# step, reset and kernel tests of the port take their specs from here
NOVELTIES = (
    ("NovelGridworld-Pogostick-v1", ("addchop",)),
    ("NovelGridworld-Pogostick-v1", ("additem", "easy", "fence")),
    ("NovelGridworld-Pogostick-v1", ("addjump",)),
    ("NovelGridworld-Pogostick-v1", ("axe", "easy", "wooden")),
    ("NovelGridworld-Pogostick-v1", ("axetobreak", "hard", "iron")),
    ("NovelGridworld-Pogostick-v1", ("breakincrease", "hard", "tree_log")),
    ("NovelGridworld-Pogostick-v1", ("crate", "medium")),
    ("NovelGridworld-Bow-v1", ("extractincdec", "hard", "decrease")),
    ("NovelGridworld-Pogostick-v1", ("fence", "easy", "oak")),
    ("NovelGridworld-Pogostick-v1", ("fencerestriction", "medium", "oak")),
    ("NovelGridworld-Pogostick-v1", ("firewall", "easy")),
    ("NovelGridworld-Pogostick-v1", ("remapaction", "easy")),
    ("NovelGridworld-Bow-v0", ("replaceitem", "easy", "wall", "stone")),
)
# two novelties stacked: an axe spawned on the map, then a fence reset edit
STACKED = ("NovelGridworld-Pogostick-v1",
           (("axe", "medium", "wooden"), ("fence", "easy", "oak")))


def novelty_specs(pkg, env_id, novelties, seed=0, map_size=10):
    """``pkg.inject_novelty`` applied in order to ``pkg.make_spec(env_id)``
    (``pkg``: ngx or ngx_torch), drawing from one ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    sp = pkg.make_spec(env_id, map_size=map_size)
    for args in novelties:
        sp = pkg.inject_novelty(sp, *args, rng=rng)
    return sp


@pytest.mark.parametrize("env_id,novelty",
                         NOVELTIES + ((STACKED[0], None),))
def test_novelty_specs_match_ngx(env_id, novelty):
    """inject_novelty builds the same spec, field by field and by key, as
    ngx's from the same RandomState (the crate contents and the remapped
    action order are drawn from it), with and without LidarInFront; the
    port accepts it."""
    novs = STACKED[1] if novelty is None else (novelty,)
    want = novelty_specs(ngx, env_id, novs)
    got = novelty_specs(nt, env_id, novs)
    assert_same_spec(got, want)
    assert_same_spec(nt.lidar_in_front(got),
                     ngx.transforms.lidar_in_front(want))
    nt.check_supported(got)
    nt.check_supported(nt.lidar_in_front(got))
    nt.check_supported(want)
    if novelty is None:
        assert [e[0] for e in got.reset_edits] == ["fence"]
        assert got.axe_mode != 0 and got.spawn_qty.sum() > \
            nt.make_spec(env_id).spawn_qty.sum()


def test_check_supported_keeps_its_gates():
    """What the port does not cover still raises: more than 32 item ids
    (the kernels' int8 map in shared memory) and an unknown reset edit."""
    sp = nt.make_spec("NovelGridworld-Pogostick-v1")
    for k in range(24):
        sp = nt.inject_novelty(sp, "additem", "easy", f"thing{k}")
    assert sp.n_items > 32
    with pytest.raises(NotImplementedError, match="32 item ids"):
        nt.check_supported(sp)
    odd = nt.make_spec("NovelGridworld-Pogostick-v1").replace(
        reset_edits=(("scatter", 1, 5, 10),))
    with pytest.raises(NotImplementedError, match="scatter"):
        nt.check_supported(odd)


def test_port_imports_without_jax():
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax'):\n"
            "    sys.modules[m] = None\n"
            "import ngx_torch, ngx_torch.rl.train, ngx_torch.ops._build\n"
            "import ngx_torch.ops.train_rollout, ngx_torch.ops.rollout\n"
            "import ngx_torch.cli.perf, ngx_torch.novelty\n"
            "import ngx_torch.transforms.actions\n"
            "assert 'ngx' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for path in (REPO / "ngx_torch").rglob("*.py"):
        text = path.read_text()
        for word in ("import jax", "from jax", "import flax", "import optax",
                     "from ngx.", "import ngx\n"):
            assert word not in text, (path, word)
