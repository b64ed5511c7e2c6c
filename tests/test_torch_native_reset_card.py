"""The native reset kernel (ngx_torch/ops/csrc/native_reset.cu) on the card,
against its plain twin run on the same card and on the CPU, and keyed
evaluation on the card against the CPU path.  Marked ``card``: each test
skips where there is no CUDA card.  This file imports no jax (the machine
with the card has none, and tests/conftest.py imports it), so run it there
with ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_native_reset_card.py``."""

import numpy as np
import pytest
import torch

import ngx_torch as nt
from ngx_torch.core import reset as R
from ngx_torch.ops import native_reset as NR
from ngx_torch.ops import threefry as TF
from ngx_torch.rl.evaluate import make_eval
from ngx_torch.utils.checkpoint import restore_checkpoint
from ngx_torch.vector import KeyedVecEnv

pytestmark = pytest.mark.card

POGO = "NovelGridworld-Pogostick-v1"
SOLVER = "trained_agents_torch/NovelGridworld-Pogostick-v1_solver/best.pt"
# Pogostick-v1, v2 (the chain's stage 0), fence medium (an edit) and a stack
SPECS = ("pogo", "v2", "fence", "stack")


def _spec(name):
    if name == "v2":
        return nt.make_spec("NovelGridworld-v2")
    rng = np.random.RandomState(0)
    sp = nt.make_spec(POGO)
    novs = {"pogo": (), "fence": (("fence", "medium", "oak"),),
            "stack": (("axe", "medium", "wooden"), ("fence", "easy", "oak"))}
    for args in novs[name]:
        sp = nt.inject_novelty(sp, *args, rng=rng)
    return sp


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the reset kernel runs only there")
    return torch.device("cuda")


def _assert_same(want, got):
    for f, w in vars(want).items():
        g = getattr(got, f)
        assert w.dtype == g.dtype and w.shape == g.shape, f
        bad = (w.cpu() != g.cpu()).reshape(w.shape[0], -1).any(1)
        assert not bool(bad.any()), f"{f}: {int(bad.sum())} rows differ"


@pytest.mark.parametrize("rows", [1, 1024, 8192])
@pytest.mark.parametrize("name", SPECS)
def test_kernel_matches_the_plain_reset_on_the_card(card, name, rows):
    """One launch a call, equal on every row to the plain reset on the card
    (explicit keys) and to the CPU path (a step's carried state on a
    parent key with an offset, about 40% of the rows done)."""
    sp = _spec(name)
    tab = R.ResetTables(sp)
    keys = TF.split(TF.key(rows), rows).to(card)
    before = NR.native_reset.launches
    got = R.native_reset_state(tab, keys)
    assert NR.native_reset.launches == before + 1
    _assert_same(R.native_reset_plain(tab, keys), got)

    state = R.native_reset_plain(tab, TF.split(TF.key(rows + 1), rows)
                                 .to(card)).replace(
        step_count=torch.full((rows,), 7, dtype=torch.int32, device=card))
    g = torch.Generator().manual_seed(rows)
    done = (torch.rand((rows,), generator=g) < 0.4).to(card)
    parent, offset = TF.fold_in(TF.key(5), rows).to(card), 3 * rows + 1
    got = R.native_reset_where(tab, state, done, parent=parent,
                               offset=offset)
    assert NR.native_reset.launches == before + 2
    want = R.native_reset_where(tab, state.to("cpu"), done.cpu(),
                                parent=parent.cpu(), offset=offset)
    _assert_same(want, got)


def test_a_cuda_tensor_never_takes_the_plain_reset(card, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain reset ran on a CUDA tensor")

    monkeypatch.setattr(R, "native_reset_plain", refuse)
    sp = _spec("fence")
    state, _ = nt.make_reset(sp, device=card)(TF.split(TF.key(0), 256)
                                              .to(card))
    vec = KeyedVecEnv(sp, episode_cap=1)
    actions = torch.zeros((256,), dtype=torch.int64, device=card)
    vec.step_rows(state, actions, TF.key(1).to(card))
    vec.scan(state, TF.key(2).to(card), 3)


def test_keyed_eval_on_the_card_equals_the_cpu(card, monkeypatch):
    """The benchmark's eval cell for one pool key (the solver, 1,024
    episodes, cap 100): the card's metrics equal the CPU path's, and the
    card launches the reset kernel once for the start reset and once a
    step."""
    params = restore_checkpoint(SOLVER)["params"]
    key = TF.fold_in(TF.key(19), 1)
    steps = []
    inner = KeyedVecEnv.step_rows

    def counted(self, *args, **kwargs):
        steps.append(1)
        return inner(self, *args, **kwargs)

    spec = nt.make_spec(POGO)
    want = make_eval(spec, cap=100, device="cpu")(
        params, key, 1024)
    monkeypatch.setattr(KeyedVecEnv, "step_rows", counted)
    before = NR.native_reset.launches
    got = make_eval(spec, cap=100, device=card)(
        params, key, 1024)
    assert got == want
    assert NR.native_reset.launches - before == 1 + len(steps) > 1
