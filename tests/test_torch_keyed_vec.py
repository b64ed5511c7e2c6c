"""The port's vector env on ngx's keys (``make_vec(..., rng='threefry')``,
ngx_torch/vector ``KeyedVecEnv``) bit for bit against ngx's ``make_vec``
on the CPU: reset, step and the scan rollout at B 64, T 32, with a cap of
5 that forces resets, ``reset_obs`` both ways, on Pogostick-v1, v3 and
fence medium under LidarInFront."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ngx
import ngx_torch as nt
from ngx.vector import make_vec as make_vec_j
from ngx_torch.ops import threefry as TF
from ngx_torch.vector import KeyedVecEnv, VecEnv
from ngx_torch.vector import make_vec as make_vec_t

from test_torch_native_reset import _rows_differing, _specs

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

B, T, CAP = 64, 32, 5
POGO = "NovelGridworld-Pogostick-v1"
SPECS = ((POGO, ()), ("NovelGridworld-v3", ()),
         (POGO, (("fence", "medium", "oak"),)))


def _lidar_specs(env_id, novs):
    spj, spt = _specs(env_id, novs)
    return ngx.transforms.lidar_in_front(spj), nt.lidar_in_front(spt)


def _policy_j(k_act, state, n):
    """A policy that reads its key and the state: ngx's form."""
    return (jax.random.randint(k_act, state.step_count.shape, 0, n)
            + state.step_count) % n


def _policy_t(n):
    def policy(k_act, state):
        return ((TF.randint(k_act, (state.batch,), 0, n).long()
                 + state.step_count.long()) % n).to(torch.int32)
    return policy


def _same(want, got, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=what)


def _compiled(fns):
    """``[(jitted fn, args)]`` compiled four at a time (XLA's compiler
    releases the GIL), which cuts the file's time by a third."""
    def build(fa):
        return fa[0].lower(*fa[1]).compile()

    with ThreadPoolExecutor(4) as pool:
        return list(pool.map(build, fns))


@pytest.mark.parametrize("env_id,novs", SPECS,
                         ids=["Pogostick-v1", "v3", "fence-medium"])
def test_keyed_vec_matches_ngx(env_id, novs):
    """From ngx's keys: the reset's states and obs; then, for
    ``reset_obs`` off and on, one step with explicit reset keys from step
    counts up to the cap (so some envs reset on it) and a T 32 rollout
    under random actions, and with ``reset_obs`` on (the trainer's form) a
    T 32 rollout under a keyed policy — every state, obs, action, reward,
    done and step cost bit for bit, with episode ends on every path."""
    spj, spt = _lidar_specs(env_id, novs)
    n = spt.n_actions
    kj = jax.random.split(jax.random.key(11), B)
    reset_j = jax.jit(make_vec_j(spj).reset)
    st0_j, ob_j = reset_j(kj)
    a = np.random.RandomState(0).randint(n, size=B).astype(np.int32)
    count = np.random.RandomState(1).randint(0, CAP, size=B).astype(np.int32)
    st_j = st0_j.replace(step_count=jnp.asarray(count))
    k2j = jax.random.split(jax.random.key(12), B)
    k3j = jax.random.key(13)
    cases, fns = [], []
    for reset_obs in (False, True):
        vj = make_vec_j(spj, episode_cap=CAP, reset_obs=reset_obs)
        fns.append((jax.jit(vj.step), (st_j, jnp.asarray(a), k2j)))
        for policy in ((None, "keyed") if reset_obs else (None,)):
            pj = None if policy is None else (
                lambda k, s: _policy_j(k, s, n))
            fns.append((jax.jit(lambda s, k, vj=vj, pj=pj: vj.rollout(
                s, k, pj, T)), (st_j, k3j)))
            cases.append((reset_obs, policy))
    compiled = _compiled(fns)

    vt0 = make_vec_t(spt, rng="threefry")
    assert isinstance(vt0, KeyedVecEnv)
    st_t, ob_t = vt0.reset(TF.split(TF.key(11), B))
    assert _rows_differing(st0_j, st_t)[0] == 0
    _same(ob_j, ob_t, "reset obs")
    st_t = st_t.replace(step_count=torch.as_tensor(count))
    assert _rows_differing(st_j, st_t)[0] == 0
    at = torch.as_tensor(a)
    k2t = TF.split(TF.key(12), B)
    i = 0
    for reset_obs in (False, True):
        vt = make_vec_t(spt, episode_cap=CAP, reset_obs=reset_obs,
                        rng="threefry")
        out_j = compiled[i](st_j, jnp.asarray(a), k2j)
        out_t = vt.step(st_t, at, k2t)
        i += 1
        assert int(out_t[3].sum()) > 0
        assert _rows_differing(out_j[0], out_t[0])[0] == 0
        for j, what in ((1, "obs"), (2, "reward"), (3, "done")):
            _same(out_j[j], out_t[j], f"reset_obs {reset_obs}: {what}")
        for policy in ((None, "keyed") if reset_obs else (None,)):
            pt = None if policy is None else _policy_t(n)
            fin_j, tr_j = compiled[i](st_j, k3j)
            fin_t, tr_t = vt.rollout(st_t, TF.key(13), pt, T)
            i += 1
            what = f"reset_obs {reset_obs}, policy {policy}"
            n_bad, fields = _rows_differing(fin_j, fin_t)
            assert n_bad == 0, f"{what}: {n_bad} envs differ in {fields}"
            for f in tr_t._fields:
                _same(getattr(tr_j, f), getattr(tr_t, f), f"{what}: {f}")
            assert int(tr_t.dones.sum()) >= B    # the cap ends every episode


def test_make_vec_forms():
    """``rng='counter'`` (the default) is the counter form, ``'threefry'``
    ngx's; another name is refused; a key batch is ``[B, 2]``."""
    sp = nt.make_spec(POGO)
    assert type(make_vec_t(sp)) is VecEnv
    assert type(make_vec_t(sp, rng="threefry")) is KeyedVecEnv
    with pytest.raises(ValueError, match="rng"):
        make_vec_t(sp, rng="philox")
    with pytest.raises(ValueError, match=r"\[B, 2\]"):
        make_vec_t(sp, rng="threefry").reset(TF.key(0))
