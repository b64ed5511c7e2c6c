"""The port's checkpoints (ngx_torch/utils/checkpoint.py): the agents under
trained_agents_torch/ against their orbax originals under trained_agents/,
and a save/restore round trip of params, Adam state and an EnvState.

The files under trained_agents_torch/ are made by this module's
``convert`` (orbax -> flax params -> ``ActorCritic.load_flax_params`` ->
``save_checkpoint``); the machine with the card has no JAX and no orbax,
so these files are how the trained agents reach it.  Regenerate them with
``JAX_PLATFORMS=cpu python tests/test_torch_checkpoint.py``.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ngx.utils.checkpoint import restore_pytree
import ngx_torch as nt
from ngx_torch.ops import threefry as TF
from ngx_torch.rl.models import ActorCritic
from ngx_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CHAIN = ("NovelGridworld-v2", "NovelGridworld-v3", "NovelGridworld-v4",
         "NovelGridworld-v5")
ENV_IDS = [f"NovelGridworld-v{i}" for i in range(7)] + [
    "NovelGridworld-Bow-v0", "NovelGridworld-Bow-v1",
    "NovelGridworld-Pogostick-v0", "NovelGridworld-Pogostick-v1"]
# the envs that ship a solver beside the trained agent
SOLVED = ("NovelGridworld-v5", "NovelGridworld-v6", "NovelGridworld-Bow-v0",
          "NovelGridworld-Bow-v1", "NovelGridworld-Pogostick-v0",
          "NovelGridworld-Pogostick-v1")
# orbax original -> the port's file: every best agent of trained_agents/
CONVERTED = {
    **{f"trained_agents/chain/{e}/best":
       f"trained_agents_torch/chain/{e}/best.pt" for e in CHAIN},
    "trained_agents/chain_solver_v5/best":
        "trained_agents_torch/chain_solver_v5/best.pt",
    **{f"trained_agents/{e}/best": f"trained_agents_torch/{e}/best.pt"
       for e in ENV_IDS + [f"{e}_solver" for e in SOLVED]},
}


def _plain(x):
    """An orbax config value as plain Python (numpy scalars and arrays
    become numbers and lists)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _flax_tree(src):
    tree = restore_pytree(str(ROOT / src))
    return (jax.tree_util.tree_map(np.asarray, tree["params"]),
            _plain(tree.get("config") or {}))


def convert(src, dst):
    """Write the orbax checkpoint ``src`` as the port's file ``dst`` (paths
    relative to the repo root): its params as an ActorCritic state dict of
    the same widths, its config as plain values."""
    params, config = _flax_tree(src)
    p = params["params"]
    nh = sum(1 for k in p if k.startswith("pi_") and k != "pi_out")
    hidden = [p[f"pi_{i}"]["kernel"].shape[1] for i in range(nh)]
    model = ActorCritic(p["pi_0"]["kernel"].shape[0],
                        p["pi_out"]["kernel"].shape[1],
                        hidden).load_flax_params(params)
    save_checkpoint(str(ROOT / dst),
                    {"params": model.state_dict(), "config": config})


@pytest.mark.parametrize("src,dst", sorted(CONVERTED.items()))
def test_converted_checkpoint_equals_orbax_original(src, dst):
    """Array for array: each torch weight is the flax kernel transposed,
    each bias the flax bias, and the config the orbax config."""
    params, config = _flax_tree(src)
    tree = restore_checkpoint(str(ROOT / dst))
    assert set(tree) == {"params", "config"}
    assert tree["config"] == config
    p = params["params"]
    sd = tree["params"]
    assert set(sd) == {f"{n}.{w}" for n in p for w in ("weight", "bias")}
    for name, leaves in p.items():
        assert np.array_equal(sd[f"{name}.weight"].numpy(),
                              leaves["kernel"].T), name
        assert np.array_equal(sd[f"{name}.bias"].numpy(), leaves["bias"]), \
            name
    hidden = tuple(config.get("hidden", (64, 64)))
    model = ActorCritic(p["pi_0"]["kernel"].shape[0],
                        p["pi_out"]["kernel"].shape[1], hidden)
    model.load_state_dict(sd)


def test_save_restore_round_trip(tmp_path):
    """Params, Adam state after two steps, an EnvState and a config come
    back equal, and load into a fresh model and optimizer."""
    spec = nt.lidar_in_front(nt.make_spec("NovelGridworld-v5"))
    state = nt.counter_reset(spec, 3, 0, 16, device="cpu")
    model = ActorCritic.from_key(TF.key(1), 71, spec.n_actions, (16, 16))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-5)
    obs = nt.make_step(spec).get_obs(state).to(torch.float32)
    for _ in range(2):
        opt.zero_grad()
        logits, value = model(obs)
        (logits.square().mean() + value.mean()).backward()
        opt.step()
    config = {"hidden": [16, 16], "env": spec.env_id, "lr": 1e-3,
              "resume": "", "seed": 0}
    path = save_checkpoint(str(tmp_path / "ck" / "resume.pt"), {
        "params": model.state_dict(), "opt_state": opt.state_dict(),
        "env_state": state, "config": config})
    assert os.path.isfile(path)
    tree = restore_checkpoint(path)
    assert tree["config"] == config
    for k, v in state.__dict__.items():
        assert torch.equal(getattr(tree["env_state"], k), v), k
    m2 = ActorCritic(71, spec.n_actions, (16, 16))
    m2.load_state_dict(tree["params"])
    opt2 = torch.optim.Adam(m2.parameters(), lr=1e-3, eps=1e-5)
    opt2.load_state_dict(tree["opt_state"])
    for (k, a), b in zip(model.state_dict().items(),
                         m2.state_dict().values()):
        assert torch.equal(a, b), k
    s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert s1.keys() == s2.keys()
    for i in s1:
        for k in s1[i]:
            assert torch.equal(s1[i][k], s2[i][k]), (i, k)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for src, dst in CONVERTED.items():
        convert(src, dst)
        print(dst, os.path.getsize(ROOT / dst), "bytes", file=sys.stderr)
