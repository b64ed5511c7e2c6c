"""ngx's env-stepping scan on the port, from ngx's keys: ``throughput_fn(
action_rng='threefry')`` (ngx_torch/vector) against ngx's ``throughput_fn``
on the CPU, B 64, T 50, on Pogostick-v1, v3 and fence medium, with
auto-reset on and off and the state carried packed."""

import numpy as np
import pytest
import torch

import jax

from ngx.vector import throughput_fn as throughput_j
from ngx_torch.ops import threefry as TF
from ngx_torch.vector import throughput_fn as throughput_t

from test_torch_native_reset import _rows_differing, _specs

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

B, T = 64, 50
POGO = "NovelGridworld-Pogostick-v1"
FENCE = (("fence", "medium", "oak"),)
# (env, novelties, the rewards' reason for an exact mean)
SCANS = ((POGO, ()), ("NovelGridworld-v3", ()), (POGO, FENCE))
FLAGS = ({}, {"auto_reset": False}, {"packed": True})


def _integral_rewards(sp):
    vals = [sp.reward_step, sp.reward_intermediate, sp.reward_done,
            sp.break_wrong_reward_default, sp.craft_success_reward,
            *np.asarray(sp.break_reward).tolist()]
    return all(float(v).is_integer() for v in vals)


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(
    f"{k}={v}" for k, v in f.items()) or "default")
@pytest.mark.parametrize("env_id,novs", SCANS,
                         ids=["Pogostick-v1", "v3", "fence-medium"])
def test_threefry_throughput_matches_ngx(env_id, novs, flags):
    """``throughput_fn(action_rng='threefry')`` from ngx's key: ngx's final
    state bit for bit at B 64, T 50.  The mean reward: every reward of these
    specs is an integer, so each step's float32 sum is exact in any order
    and the mean (the sum times the float32 reciprocal of B*T, as XLA
    computes ngx's division) is equal; a spec with a fractional reward
    would be held within 1e-6 relative, its sums' order being XLA's."""
    spj, spt = _specs(env_id, novs)
    st_j, mean_j = throughput_j(spj, B, T, **flags)(jax.random.key(7))
    st_t, mean_t = throughput_t(spt, B, T, action_rng="threefry",
                                device="cpu", **flags)(TF.key(7))
    n, fields = _rows_differing(st_j, st_t)
    assert n == 0, f"{n} of {B} envs differ from ngx's in {fields}"
    assert mean_t.dtype == torch.float32
    if _integral_rewards(spt):
        assert float(mean_t) == float(mean_j)
    else:
        np.testing.assert_allclose(float(mean_t), float(mean_j), rtol=1e-6)
    if not flags:
        # a seed is key(seed)
        st_s, mean_s = throughput_t(spt, B, T, action_rng="threefry",
                                    device="cpu")(7)
        assert _rows_differing(st_j, st_s)[0] == 0
        assert float(mean_s) == float(mean_t)


