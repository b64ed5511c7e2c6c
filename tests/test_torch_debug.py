"""NGX_DEBUG=1 in the port (ngx_torch/utils/debug.py) against ngx's
(ngx/utils/debug.py), case for case with tests/test_debug.py, on the CPU.

The flag is read when a step, a reset or a kernel entry is built, so each
test builds its own under ``monkeypatch``.  ngx's asserts under ``jax.vmap``
run once per env and name index 0; the port's batch is one call and names
the env's row (its docstring), so the texts are held equal on one env."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ngx_torch as nt
from ngx_torch.core.state import EnvState
from ngx_torch.utils import debug

torch.set_num_threads(1)

POGO = "NovelGridworld-Pogostick-v1"


@pytest.fixture()
def debug_env(monkeypatch):
    monkeypatch.setenv("NGX_DEBUG", "1")
    spec = nt.make_spec(POGO)
    return spec, nt.make_step(spec)


def _reset(spec, n=1, seed=0):
    return nt.counter_reset(spec, seed, 0, n, device="cpu")


def _act(n, a=0):
    return torch.full((n,), a, dtype=torch.int32)


def test_debug_clean_run_passes(debug_env):
    spec, step = debug_env
    state = _reset(spec)
    for a in range(spec.n_actions):
        state, obs, r, d, i = step(state, _act(1, a))
    assert state.batch == 1


def test_debug_catches_negative_inventory(debug_env):
    spec, step = debug_env
    state = _reset(spec)
    inv = state.inventory.clone()
    inv[0, 1] = -3
    with pytest.raises(AssertionError, match="inventory"):
        step(state.replace(inventory=inv), _act(1))


def test_debug_catches_broken_wall_ring(debug_env):
    spec, step = debug_env
    state = _reset(spec)
    m = state.map.clone()
    m[0, 0] = 0                                     # corner wall -> air
    with pytest.raises(AssertionError, match="wall ring"):
        step(state.replace(map=m), _act(1))


def test_debug_catches_violation_in_batch(debug_env):
    spec, _ = debug_env
    from ngx_torch.vector import make_vec
    vec = make_vec(spec)
    vs, _ = vec.reset(1, 4, device="cpu")
    vec.step(vs, _act(4), 1, 1)                     # clean batch passes
    inv = vs.inventory.clone()
    inv[2, 3] = -5
    with pytest.raises(AssertionError,
                       match=r"inventory >= 0 \(env index 2 of the callback "
                             r"batch; 1 total violations\)"):
        vec.step(vs.replace(inventory=inv), _act(4), 1, 1)


def test_debug_off_by_default(monkeypatch):
    monkeypatch.delenv("NGX_DEBUG", raising=False)
    spec = nt.make_spec(POGO)
    step = nt.make_step(spec)
    # the step is the undecorated function: no wrapper closes over it
    assert "inner_step" not in step.__code__.co_freevars
    monkeypatch.setenv("NGX_DEBUG", "1")
    assert "inner_step" in nt.make_step(spec).__code__.co_freevars
    monkeypatch.delenv("NGX_DEBUG")

    def no_host_read(*a, **k):
        raise RuntimeError("an assert ran with the flag off")

    monkeypatch.setattr(debug, "kernel_asserts", no_host_read)
    state = _reset(spec)
    inv = state.inventory.clone()
    inv[0, 1] = -3
    out = step(state.replace(inventory=inv), _act(1))  # steps, no raise
    assert int(out[0].inventory[0, 1]) == -3
    nt.counter_reset(spec, 0, 0, 2, device="cpu")
    from ngx_torch.vector import make_vec
    vec = make_vec(spec)
    vs, _ = vec.reset(0, 4, device="cpu")
    vec.step(vs, _act(4), 0, 1)


def _corrupt(st, kind, spec):
    s = {k: v.copy() for k, v in st.items()}
    H, I = spec.map_size, spec.n_items
    if kind in ("inventory", "both"):
        s["inventory"][0, 1] = -3
    if kind in ("ring", "both"):
        s["map"][0, 0] = 0
    if kind == "agent":
        s["agent"][0] = (0, 5)
    if kind == "cell":
        cell = H * 5 + 5
        if s["agent"][0].tolist() == [5, 5]:
            cell += 1
        s["map"][0, cell] = I + 2
    if kind == "selected":
        s["selected"][0] = I + 3
    return s


@pytest.mark.parametrize("kind", ["inventory", "ring", "agent", "cell",
                                  "selected", "both"])
def test_debug_message_equals_ngx(monkeypatch, kind):
    """The same corrupted state, built in numpy, through ngx's debug step
    and the port's: the same AssertionError text."""
    monkeypatch.setenv("NGX_DEBUG", "1")
    import ngx
    spec = nt.make_spec(POGO)
    left = spec.actions_id["Left"]
    st = _corrupt(_reset(spec, seed=3).to_numpy(), kind, spec)
    with pytest.raises(AssertionError) as got:
        nt.make_step(spec)(EnvState.from_ngx(type("S", (), st)()),
                           _act(1, left))
    step_j = jax.jit(ngx.make_step(ngx.make_spec(POGO)))
    with pytest.raises(Exception) as want:
        out = step_j(ngx.EnvState(**{k: jnp.asarray(v[0])
                                     for k, v in st.items()}),
                     jnp.int32(left))
        jax.block_until_ready(out[0].map)
    text = re.search(r"NGX_DEBUG: invariant violated after step: .*? "
                     r"total violations\)", str(want.value)).group(0)
    assert str(got.value) == text


@pytest.mark.parametrize("facing", [5, -1])
@pytest.mark.parametrize("action", ["Forward", "Break", "Left"])
def test_debug_corrupt_facing_equals_ngx(monkeypatch, facing, action):
    """A facing outside 0-3 through ngx's debug step and the port's: after a
    non-turn action the facing stays and both raise ngx's text; a turn
    gives facing 0 (ngx's one-hot read), which passes in both."""
    monkeypatch.setenv("NGX_DEBUG", "1")
    import ngx
    spec = nt.make_spec(POGO)
    a = spec.actions_id[action]
    st = _reset(spec, seed=3).to_numpy()
    st["facing"][0] = facing
    step_j = jax.jit(ngx.make_step(ngx.make_spec(POGO)))

    def ngx_step():
        out = step_j(ngx.EnvState(**{k: jnp.asarray(v[0])
                                     for k, v in st.items()}), jnp.int32(a))
        jax.block_until_ready(out[0].map)
        return out

    def port_step():
        return nt.make_step(spec)(EnvState.from_ngx(type("S", (), st)()),
                                  _act(1, a))

    if action == "Left":
        assert int(ngx_step()[0].facing) == 0
        assert int(port_step()[0].facing[0]) == 0
        return
    with pytest.raises(AssertionError) as got:
        port_step()
    with pytest.raises(Exception) as want:
        ngx_step()
    text = re.search(r"NGX_DEBUG: invariant violated after step: .*? "
                     r"total violations\)", str(want.value)).group(0)
    assert "facing in {0,1,2,3}" in text
    assert str(got.value) == text


def test_debug_reset_hooks(monkeypatch):
    """counter_reset and VecEnv's reset draws assert under "reset" on a
    corrupted draw; ngx's make_reset hook names the same place."""
    monkeypatch.setenv("NGX_DEBUG", "1")
    import ngx_torch.core.reset as R
    import ngx_torch.vector as V
    spec = nt.make_spec(POGO)
    real = R.reset_rows

    def bad_rows(*a, **k):
        st = real(*a, **k)
        inv = st.inventory.clone()
        inv[-1, 2] = -1
        return st.replace(inventory=inv)

    monkeypatch.setattr(R, "reset_rows", bad_rows)
    monkeypatch.setattr(V, "reset_rows", bad_rows)
    msg = r"after reset: inventory >= 0 \(env index {}"
    with pytest.raises(AssertionError, match=msg.format(2)):
        nt.counter_reset(spec, 0, 0, 3, device="cpu")
    vec = V.make_vec(spec, episode_cap=1)
    with pytest.raises(AssertionError, match=msg.format(3)):
        vec.reset(0, 4, device="cpu")
    monkeypatch.setattr(V, "reset_rows", real)
    vs, _ = vec.reset(0, 4, device="cpu")
    monkeypatch.setattr(V, "reset_rows", bad_rows)
    with pytest.raises(AssertionError, match=msg.format(3)):
        vec.step(vs, _act(4), 0, 1)      # the cap ends all 4: 4 fresh rows


def test_debug_validates_input_state(debug_env):
    spec, step = debug_env
    state = _reset(spec)
    with pytest.raises(AssertionError, match="inventory dtype"):
        step(state.replace(inventory=state.inventory.long()), _act(1))
    with pytest.raises(AssertionError, match="map shape"):
        step(state.replace(map=state.map[:, :-1]), _act(1))


def test_debug_refuses_kernel_entries(monkeypatch):
    """Under the flag the kernel entries raise RuntimeError at build time
    with device="cpu", as ngx's make_pallas_* functions raise in interpret
    mode; rollout_backend='xla' trains with the asserts."""
    monkeypatch.setenv("NGX_DEBUG", "1")
    from ngx.ops.pallas_rollout import (make_pallas_rollout,
                                        make_pallas_train_rollout)
    import ngx
    from ngx_torch.ops.rollout import make_rollout
    from ngx_torch.parallel import (make_env_mesh, make_spmd_rollout,
                                    sharded_throughput_fn)
    from ngx_torch.rl.curriculum import make_train_chain
    from ngx_torch.rl.train import PPOConfig, make_train
    from ngx_torch.vector import throughput_fn

    prefix = r"NGX_DEBUG=1 is unsupported in the \w+ rollout path"
    spec_j = ngx.make_spec(POGO)
    with pytest.raises(RuntimeError, match=prefix):
        make_pallas_rollout(spec_j, 64, 4, block=64, interpret=True)
    with pytest.raises(RuntimeError, match=prefix):
        make_pallas_train_rollout(
            ngx.transforms.lidar_in_front(spec_j), 128, 4, interpret=True)
    spec = nt.make_spec(POGO)
    mesh = make_env_mesh(device="cpu")
    cfg = PPOConfig(num_envs=128, rollout_steps=4, num_minibatches=2,
                    epochs=1, hidden=(16, 16), episode_cap=8)
    refused = [
        lambda: make_rollout(spec, 64, 4, block=64, device="cpu"),
        lambda: make_rollout(spec, 64, 4, block=64, action_source="input",
                             device="cpu"),
        lambda: throughput_fn(spec, 64, 4, device="cpu"),
        lambda: sharded_throughput_fn(spec, mesh, 64, 4),
        lambda: make_spmd_rollout(spec, mesh, 64, 4),
        lambda: make_spmd_rollout(spec, mesh, 64, 4, packed=True),
        lambda: make_train(cfg, device="cpu"),
        lambda: make_train(cfg, rollout_backend="pallas", device="cpu"),
        lambda: make_train_chain(
            PPOConfig(env_id="NovelGridworld-v3", num_envs=128,
                      rollout_steps=4), ["NovelGridworld-v2",
                                         "NovelGridworld-v3"], [None],
            pool_size=64, device="cpu"),
    ]
    for build in refused:
        with pytest.raises(RuntimeError, match=prefix):
            build()
    init, step = make_train(cfg, rollout_backend="xla", device="cpu")
    carry, metrics = step(init(0), 1)
    assert np.isfinite(float(metrics["pg_loss"]))
