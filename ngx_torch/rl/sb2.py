"""Load the reference's shipped stable-baselines-2 checkpoints — the port of
``ngx/rl/sb2.py``.

The reference ships PPO2 agents for the legacy envs as
``trained_agents/NovelGridworld-v{0..4}.zip`` and replays them in its eval
driver (reference ``enjoy.py:49-72``).  The SB2 save format needs no
TensorFlow to read: the zip holds a ``parameters`` member that is a plain
``.npz`` whose keys are TF variable names (``model/pi_fc0/w:0`` …), and the
policy SB2's ``MlpPolicy`` builds for these envs is a 2x64-tanh MLP over the
env's lidar observation with separate pi/vf towers
(stable-baselines ``common/policies.py`` ``mlp_extractor``).

:func:`load_sb2_params` reads those weights into plain numpy;
:func:`sb2_apply` is the same forward pass in plain torch, on the device of
its obs, so the reference authors' own policies run through the port
(``ngx_torch.cli.enjoy``, ``ngx_torch.rl.evaluate.evaluate_sb2_zip``).
"""

from __future__ import annotations

import io
import zipfile

import numpy as np
import torch


def load_sb2_params(zip_path: str) -> dict:
    """Read an SB2 model zip -> {'pi': [(W,b)...], 'vf': [(W,b)...]}.

    ``pi`` ends with the action-logits head, ``vf`` with the 1-unit value
    head; hidden layers use tanh (SB2 MlpPolicy default, layers=[64, 64]).
    """
    with zipfile.ZipFile(zip_path) as z:
        d = np.load(io.BytesIO(z.read("parameters")))
        names = set(d.files)

        def tower(prefix, head):
            layers = []
            i = 0
            while f"model/{prefix}_fc{i}/w:0" in names:
                layers.append((np.asarray(d[f"model/{prefix}_fc{i}/w:0"],
                                          np.float32),
                               np.asarray(d[f"model/{prefix}_fc{i}/b:0"],
                                          np.float32)))
                i += 1
            layers.append((np.asarray(d[f"model/{head}/w:0"], np.float32),
                           np.asarray(d[f"model/{head}/b:0"], np.float32)))
            return layers

        return {"pi": tower("pi", "pi"), "vf": tower("vf", "vf")}


def sb2_apply(params, obs):
    """The SB2 MlpPolicy forward pass: obs [B, D] -> (logits [B, A],
    value [B]), float32 on ``obs``'s device.  ``params`` holds numpy arrays
    (:func:`load_sb2_params`) or tensors (:func:`sb2_to_device`).  Hidden
    activations are tanh; heads are linear."""
    dev = obs.device

    def dense(h, layer):
        W, b = layer
        return h @ torch.as_tensor(W, device=dev) + torch.as_tensor(
            b, device=dev)

    def tower(layers, h):
        for layer in layers[:-1]:
            h = torch.tanh(dense(h, layer))
        return dense(h, layers[-1])

    obs = obs.to(torch.float32)
    logits = tower(params["pi"], obs)
    value = tower(params["vf"], obs)[..., 0]
    return logits, value


def sb2_to_device(params, device) -> dict:
    """``params`` with every array a float32 tensor on ``device``, so
    :func:`sb2_apply` copies nothing a call."""
    return {k: [(torch.as_tensor(W, dtype=torch.float32, device=device),
                 torch.as_tensor(b, dtype=torch.float32, device=device))
                for W, b in layers] for k, layers in params.items()}


def check_dims(params, obs_dim: int, n_actions: int, zip_path: str = ""):
    """Assert the checkpoint's IO dims match the spec's obs/action layout."""
    in_dim = params["pi"][0][0].shape[0]
    out_dim = params["pi"][-1][0].shape[1]
    if in_dim != obs_dim or out_dim != n_actions:
        raise ValueError(
            f"SB2 checkpoint {zip_path or ''} expects obs_dim={in_dim}, "
            f"n_actions={out_dim}; the env spec has obs_dim={obs_dim}, "
            f"n_actions={n_actions}")
