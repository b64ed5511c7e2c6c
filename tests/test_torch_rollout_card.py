"""The stepping kernel's launch geometry on the card (ngx_torch/ops/csrc/
rollout.cu warp_residency): a fenced 'prng' launch that the residency rule
widens against one it leaves at the floor of RESET_LANES, row for row, and
the launches it leaves as they were.
Marked ``card``: each test skips where there is no CUDA card.  This file
imports no jax (the machine with the card has none, and tests/conftest.py
imports it), so run it there with ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_rollout_card.py``."""

import pytest
import torch

import ngx_torch as nt
from ngx_torch.ops import rollout as R

pytestmark = pytest.mark.card

POGO = "NovelGridworld-Pogostick-v1"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the rollout kernel runs only there")
    return torch.device("cuda")


def _fenced():
    """The fenced stepping cell's spec: fence medium oak under
    LidarInFront."""
    return nt.lidar_in_front(nt.inject_novelty(nt.make_spec(POGO), "fence",
                                               "medium", "oak"))


@pytest.mark.parametrize("steps", [64, 1024])
def test_widened_launch_matches_the_narrow_one_on_the_card(card, steps):
    """Fence medium at B 65,536 takes lanes 2, 4 blocks an SM (the
    runtime's occupancy query) and one wave; at B 8,192 it stays at lanes
    1.  The envs' RNG streams are the logical block's, so rows 0-8,191 of
    the first equal the second bit for bit: map, registers, inventory,
    reward sums and done counts.  rollout.widened counts the first launch
    only."""
    spec, n, seed = _fenced(), 8192, 2 ** 31 - 17
    widened = dict(R.rollout.widened)
    wide = R.rollout(spec, 8 * n, steps, seed, device=card)
    geo = R.launch.geometry
    assert (geo["threads"], geo["lanes"], geo["sm_blocks"], geo["waves"],
            geo["widened"]) == (128, 2, 4, 1, 1), geo
    narrow = R.rollout(spec, n, steps, seed, device=card)
    geo = R.launch.geometry
    assert (geo["lanes"], geo["waves"], geo["widened"]) == (1, 1, 0), geo
    assert R.rollout.widened["prng"] == widened["prng"] + 1
    assert {k: v for k, v in R.rollout.widened.items() if k != "prng"} == \
        {k: v for k, v in widened.items() if k != "prng"}
    for f, w in vars(narrow[0]).items():
        g = getattr(wide[0], f)[:n]
        bad = (w != g).reshape(n, -1).any(1)
        assert not bool(bad.any()), f"{f}: {int(bad.sum())} rows differ"
    assert torch.equal(wide[1][:n], narrow[1])
    assert torch.equal(wide[2][:n], narrow[2])


def test_pool_draw_and_plain_spec_keep_their_geometry(card):
    """The fence train cell's pool draw (32,768 rows at T 0) fits one wave
    at lanes 1, and the plain spec has no score rows: neither is
    widened."""
    widened = sum(R.rollout.widened.values())
    R.pool_reset(_fenced(), 32768, 13, device=card)
    geo = R.launch.geometry
    assert (geo["lanes"], geo["waves"], geo["widened"]) == (1, 1, 0), geo
    R.rollout(nt.lidar_in_front(nt.make_spec(POGO)), 65536, 4, 5,
              device=card)
    geo = R.launch.geometry
    assert (geo["lanes"], geo["waves"], geo["widened"]) == (1, 1, 0), geo
    assert sum(R.rollout.widened.values()) == widened
