"""The port's PPO math and trainer (ngx_torch/rl/train.py) against
ngx.rl.train: GAE, one update from the same params, trajectory and
permutations, and one full train step on CPU."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.training.train_state import TrainState as FlaxTrainState

from ngx.rl import train as J
from ngx.rl.models import ActorCritic as FlaxActorCritic
from ngx_torch.rl import train as Tt
from ngx_torch.rl.models import ActorCritic

# one torch thread per test process: xdist runs several on the CPU, where
# more threads only contend (the port's suite runs twice as fast)
torch.set_num_threads(1)


def _cfgs(**kw):
    return J.PPOConfig(**kw), Tt.PPOConfig(**kw)


def test_config_fields_and_defaults_match():
    assert [(f.name, f.default) for f in dataclasses.fields(J.PPOConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(Tt.PPOConfig)]


def test_gae_matches():
    cfg_j, cfg_t = _cfgs()
    T, B = 16, 32
    rng = np.random.RandomState(0)
    values = rng.randn(T, B).astype(np.float32)
    rewards = rng.randn(T, B).astype(np.float32)
    dones = rng.rand(T, B) < 0.2
    last = rng.randn(B).astype(np.float32)
    gae_j, _ = J.make_ppo_core(cfg_j, None)
    gae_t, _ = Tt.make_ppo_core(cfg_t)
    adv_j, tgt_j = gae_j(jnp.asarray(values), jnp.asarray(rewards),
                         jnp.asarray(dones), jnp.asarray(last))
    adv_t, tgt_t = gae_t(torch.as_tensor(values), torch.as_tensor(rewards),
                         torch.as_tensor(dones), torch.as_tensor(last))
    np.testing.assert_allclose(adv_t.numpy(), np.asarray(adv_j), atol=1e-6)
    np.testing.assert_allclose(tgt_t.numpy(), np.asarray(tgt_j), atol=1e-6)


@pytest.mark.parametrize("shuffle", ["permutation", "affine"])
def test_update_matches(shuffle):
    """One update (2 epochs x 4 minibatches of Adam steps after the global
    norm clip) from the same params, trajectory and permutations."""
    cfg_j, cfg_t = _cfgs(epochs=2, num_minibatches=4, hidden=(16, 16),
                         shuffle=shuffle)
    obs_dim, A, N = 63, 17, 512
    model = FlaxActorCritic(n_actions=A, hidden=cfg_j.hidden)
    params = model.init(jax.random.key(0), jnp.zeros((1, obs_dim)))
    rng = np.random.RandomState(1)
    obs = rng.randint(0, 9, (N, obs_dim)).astype(np.float32)
    action = rng.randint(A, size=N).astype(np.int32)
    logits, _ = model.apply(params, jnp.asarray(obs))
    logp = np.asarray(jax.nn.log_softmax(logits))[np.arange(N), action] \
        + 0.05 * rng.randn(N).astype(np.float32)
    adv = rng.randn(N).astype(np.float32)
    target = 3 * rng.randn(N).astype(np.float32)
    batch = (obs, action, logp.astype(np.float32), adv, target)

    tx = optax.chain(optax.clip_by_global_norm(cfg_j.max_grad_norm),
                     optax.adam(cfg_j.lr, eps=1e-5))
    ts = FlaxTrainState.create(apply_fn=model.apply, params=params, tx=tx)
    _, update_j = J.make_ppo_core(cfg_j, model)
    key = jax.random.key(5)
    ts_j, (pg_j, vl_j, ent_j) = jax.jit(update_j)(
        ts, tuple(jnp.asarray(x) for x in batch), key)
    # the epochs' permutations, drawn as ngx's update draws them
    keys = jax.random.split(key, cfg_j.epochs)
    if shuffle == "affine":
        perms = []
        for k in keys:
            a = jax.random.randint(k, (), 0, N // 2) * 2 + 1
            r = jax.random.randint(jax.random.fold_in(k, 1), (), 0, N)
            perms.append(np.asarray((jnp.arange(N) * a + r) % N))
    else:
        perms = [np.asarray(jax.random.permutation(k, N)) for k in keys]

    m = ActorCritic(obs_dim, A, cfg_t.hidden).load_flax_params(
        jax.tree_util.tree_map(np.asarray, params))
    ts_t = Tt.TrainState(m, torch.optim.Adam(m.parameters(), lr=cfg_t.lr,
                                             eps=1e-5))
    _, update_t = Tt.make_ppo_core(cfg_t)
    pg_t, vl_t, ent_t = update_t(ts_t, tuple(torch.as_tensor(x)
                                             for x in batch), perms=perms)
    # rtol 1e-5, plus 1e-6 absolute for entries near zero: Adam's step is
    # lr * m / (sqrt(v) + eps) per entry, and where an entry's gradient
    # nearly cancels, float32 sums in another order move m / sqrt(v) by
    # ~1e-3 — at lr 2.5e-4 over these 8 steps, under 1e-6
    pj = ts_j.params["params"]
    for name, lin in m.named_children():
        np.testing.assert_allclose(lin.weight.detach().numpy().T,
                                   np.asarray(pj[name]["kernel"]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(lin.bias.detach().numpy(),
                                   np.asarray(pj[name]["bias"]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    for got, want in ((vl_t, vl_j), (ent_t, ent_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # the clipped surrogate is a mean of O(1) terms that cancel to ~1e-3:
    # float32 rounding in another summation order shows up at the 1e-7
    # level in absolute terms, not relative to the small mean
    np.testing.assert_allclose(pg_t.numpy(), np.asarray(pg_j), rtol=0,
                               atol=1e-6)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.RandomState(3)
    grads = [rng.randn(5, 4).astype(np.float32), rng.randn(4).astype(np.float32)]
    for scale in (0.01, 10.0):
        want, _ = optax.clip_by_global_norm(0.5).update(
            [jnp.asarray(g * scale) for g in grads], None)
        ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(ps, grads):
            p.grad = torch.as_tensor(g * scale)
        Tt.clip_by_global_norm(ps, 0.5)
        for p, w in zip(ps, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                       rtol=1e-6)


def test_train_step_cpu():
    cfg_j, cfg_t = _cfgs(num_envs=128, rollout_steps=4, num_minibatches=2,
                         epochs=1, hidden=(16, 16))
    init, train_step = Tt.make_train(cfg_t, device="cpu")
    carry = init(0)
    count0 = carry[1].step_count.clone()
    carry, metrics = train_step(carry, 1)
    m = {k: float(v) for k, v in metrics.items()}
    assert all(np.isfinite(v) for v in m.values()), m
    assert bool((carry[1].step_count > count0).all())
    assert carry[2].shape == (128, 63)
    init_j, step_j = J.make_train(cfg_j, rollout_backend="xla")
    _, metrics_j = jax.jit(step_j)(init_j(jax.random.key(0)),
                                   jax.random.key(1))
    assert sorted(metrics) == sorted(metrics_j)
    carry, history = Tt.train(cfg_t, 2, seed=3, log_every=1, device="cpu")
    assert len(history) == 2 and sorted(history[0]) == sorted(metrics_j)
    with pytest.raises(ValueError, match="128-env block"):
        Tt.make_train(Tt.PPOConfig(num_envs=100))
    with pytest.raises(NotImplementedError):
        Tt.make_train(cfg_t, mesh=object())


def test_make_train_defaults_to_the_card():
    """Without a device the trainer runs on the card; where there is none
    it raises, and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    cfg = Tt.PPOConfig(num_envs=128, rollout_steps=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Tt.make_train(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Tt.train(cfg, 1)


def test_reset_source_is_ngx_rule():
    """The pool source exactly where ngx's trainer takes it
    (ngx/rl/train.py:330-332): reset edits, the v3 wall coin, the
    Pogostick-v0 tap."""
    import ngx
    import ngx_torch as nt

    fence = ("NovelGridworld-Pogostick-v1", ("fence", "medium", "oak"))
    cases = {"NovelGridworld-v3": "pool", "NovelGridworld-Pogostick-v0": "pool",
             fence: "pool", "NovelGridworld-Pogostick-v1": "native",
             "NovelGridworld-v5": "native"}
    cfg = Tt.PPOConfig(num_envs=128, rollout_steps=4)
    for case, want in cases.items():
        if isinstance(case, tuple):
            spt = nt.inject_novelty(nt.make_spec(case[0]), *case[1])
            spj = ngx.inject_novelty(ngx.make_spec(case[0]), *case[1])
        else:
            spt, spj = nt.make_spec(case), ngx.make_spec(case)
        plain = (not spj.reset_edits and not spj.reset_wall_coin
                 and not spj.reset_place_tap)
        assert ("native" if plain else "pool") == want
        assert Tt.reset_source(spt) == want
        _, step = Tt.make_train(cfg, spec_override=spt, device="cpu")
        assert step.reset_source == want


def test_train_step_pool_cpu():
    """Two train steps on fence medium (cap 8, T 12) take the pool source:
    every env crosses a boundary, and the first step's rollout is the
    kernel's twin in pool mode from the seeds the step's generator draws,
    rollout seed first, then the pool's."""
    import ngx_torch as nt
    from ngx_torch.core.reset import counter_reset
    from ngx_torch.ops.train_rollout import train_rollout_plain

    spec = nt.lidar_in_front(nt.inject_novelty(
        nt.make_spec("NovelGridworld-Pogostick-v1"), "fence", "medium", "oak"))
    cfg = Tt.PPOConfig(num_envs=128, rollout_steps=12, episode_cap=8,
                       num_minibatches=2, epochs=1, hidden=(16, 16))
    init, train_step = Tt.make_train(cfg, spec_override=spec, device="cpu")
    assert train_step.reset_source == "pool"
    carry = init(0)
    g = torch.Generator().manual_seed(1)
    roll_seed = int(torch.randint(0, Tt._SEED_HI, (), generator=g))
    pool_seed = int(torch.randint(0, Tt._SEED_HI, (), generator=g))
    layers = [(w.detach().clone(), b.detach().clone())
              for w, b in carry[0].model.pi_layers()]
    want = train_rollout_plain(
        spec, carry[1], layers, roll_seed, 12, block=128, cap=8,
        pool=counter_reset(spec, pool_seed, 0, 128 * Tt.POOL_SLOTS),
        base=torch.zeros((128,), dtype=torch.int32))
    carry, m1 = train_step(carry, 1)
    for k, v in want[0].__dict__.items():
        assert torch.equal(getattr(carry[1], k), v), k
    carry, m2 = train_step(carry, 2)
    for m in (m1, m2):
        assert int(m["episodes"]) >= 128
        assert all(np.isfinite(float(v)) for v in m.values()), m
