"""The categorical kernel (ngx_torch/ops/csrc/categorical.cu) on the card,
against its plain twin (ngx_torch/ops/threefry.py ``categorical``) run on the
same card, bit for bit; keyed evaluation and the chain's stage play with the
kernel against the same paths with the plain draw swapped in.  Marked
``card``: each test skips where there is no CUDA card.  This file imports no
jax (the machine with the card has none, and tests/conftest.py imports it),
so run it there with ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_categorical_card.py``."""

import pytest
import torch

import ngx_torch as nt
import ngx_torch.rl.curriculum as CUR
import ngx_torch.rl.evaluate as EV
from ngx_torch.ops import categorical as CK
from ngx_torch.ops import threefry as TF
from ngx_torch.ops.categorical import categorical
from ngx_torch.utils.checkpoint import restore_checkpoint

pytestmark = pytest.mark.card

POGO = "NovelGridworld-Pogostick-v1"
SOLVER = "trained_agents_torch/NovelGridworld-Pogostick-v1_solver/best.pt"
CHAIN = ["NovelGridworld-v2", "NovelGridworld-v3", "NovelGridworld-v4",
         "NovelGridworld-v5"]
KEYS = 8
# each key set is KEYS keys of its own
KEY_SETS = (0, 1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the categorical kernel runs only there")
    return torch.device("cuda")


def _logits(rows, n_actions, seed, card):
    """Normal logits (scale 2), a quarter of the entries -inf, a row of
    -inf, a row with +inf at two actions (an exact tie) and a row of equal
    logits."""
    g = torch.Generator().manual_seed(seed)
    x = 2.0 * torch.randn((rows, n_actions), generator=g)
    x[torch.rand((rows, n_actions), generator=g) < 0.25] = float("-inf")
    if rows > 3:
        x[1] = float("-inf")
        x[2, [n_actions // 2, n_actions - 1]] = float("inf")
        x[3] = 0.5
    return x.to(card)


@pytest.mark.parametrize("key_set", KEY_SETS)
@pytest.mark.parametrize("n_actions", (2, 17, 18, 40))
@pytest.mark.parametrize("rows", (1, 3, 1024))
def test_kernel_equals_the_twin_on_the_card(card, rows, n_actions, key_set):
    """One launch a call; every action equal to the twin's on the card,
    over ``KEYS`` keys, and on a 0 / -inf mask."""
    for seed in range(key_set * KEYS, (key_set + 1) * KEYS):
        key = TF.fold_in(TF.key(rows + seed), n_actions).to(card)
        logits = _logits(rows, n_actions, seed * 1000 + rows + n_actions,
                         card)
        before = CK.launches
        got = categorical(key, logits)
        assert CK.launches == before + 1
        assert got.device == logits.device and got.dtype == torch.int64
        assert torch.equal(got, TF.categorical(key, logits))
        mask = torch.where(torch.isfinite(logits), 0.0, float("-inf"))
        assert torch.equal(categorical(key, mask),
                           TF.categorical(key, mask))


def test_a_cuda_tensor_never_takes_the_plain_draw(card, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain draw ran on a CUDA tensor")

    monkeypatch.setattr(TF, "categorical", refuse)
    got = categorical(TF.key(1).to(card), torch.zeros((64, 17), device=card))
    assert got.shape == (64,)


def _plain_draw(monkeypatch):
    """Swap the plain draw in for the kernel."""
    monkeypatch.setattr(CK, "categorical",
                        lambda key, logits: TF.categorical(key, logits))


def test_keyed_eval_with_the_kernel_equals_the_plain_draw(card, monkeypatch):
    """The benchmark's eval cell for one pool key (the solver, 1,024
    episodes, cap 100): the metrics equal those of the plain draw on the
    card, and the kernel launches once a step, as the span counts."""
    params = restore_checkpoint(SOLVER)["params"]
    key = TF.fold_in(TF.key(19), 1)
    run = EV.make_eval(nt.make_spec(POGO), cap=100, device=card)
    steps = []
    inner = EV.play_first_done

    def counted(step, act, *args, **kwargs):
        def counting(t, obs):
            steps.append(t)
            return act(t, obs)
        return inner(step, counting, *args, **kwargs)

    monkeypatch.setattr(EV, "play_first_done", counted)
    before = CK.launches
    got = run(params, key, 1024)
    assert CK.launches - before == len(steps) > 1
    n_steps = len(steps)
    _plain_draw(monkeypatch)
    steps.clear()
    want = run(params, key, 1024)
    assert got == want and len(steps) == n_steps
    assert CK.launches - before == n_steps


def test_the_chain_with_the_kernel_equals_the_plain_draw(card, monkeypatch):
    """make_chain_reset over v2 -> v5 with the trained stage policies at
    1,024 rows: every leaf of every row equal to the plain draw's, and one
    launch a stage step; evaluate_chain's metrics equal too."""
    stages = [restore_checkpoint(f"trained_agents_torch/chain/{e}/best.pt")
              ["params"] for e in CHAIN[:-1]]
    key = TF.key(23)
    chain, _ = CUR.make_chain_reset(CHAIN, stages, 1024, 100, card)
    draws = []

    def counted(key, logits):
        draws.append(1)
        return categorical(key, logits)

    monkeypatch.setattr(CK, "categorical", counted)
    before = CK.launches
    got, got_obs = chain(key)
    assert CK.launches - before == len(draws) > 0
    _plain_draw(monkeypatch)
    want, want_obs = chain(key)
    assert CK.launches - before == len(draws)
    for f, w in vars(want).items():
        assert torch.equal(getattr(got, f), w), f
    assert torch.equal(got_obs, want_obs)
    monkeypatch.undo()
    final = restore_checkpoint("trained_agents_torch/chain/"
                               "NovelGridworld-v5/best.pt")["params"]
    got_eval = CUR.evaluate_chain(CHAIN, stages, final, episodes=256,
                                  seed=4, device=card)
    _plain_draw(monkeypatch)
    assert got_eval == CUR.evaluate_chain(CHAIN, stages, final,
                                          episodes=256, seed=4, device=card)
