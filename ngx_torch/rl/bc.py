"""Behaviour-cloning pretrain from recorded expert demonstrations — the port
of ``ngx/rl/bc.py`` (``load_demos`` ``:22``, ``pretrain`` ``:31``,
``pretrain_from_npz`` ``:78``).

The reference warm-starts PPO2 from an SB2 ``ExpertDataset`` ``.npz``
(reference ``tests/train.py:125-132``).  The ``.npz`` layout is the one
``ngx.cli.record_demos`` writes: ``obs [N, obs_dim]``, ``actions [N, 1]``.
Only the policy head's cross-entropy trains; the value head is left for
PPO.  The optimizer is ``torch.optim.Adam`` at torch's defaults (b1 0.9, b2
0.999, eps 1e-8 outside the square root), which are ``optax.adam``'s.

The minibatches are ngx's draws (:mod:`ngx_torch.ops.threefry`): step
``t``'s rows ``randint(split(key, steps)[t], (bs,), 0, N)``, ``key(0)``
by default as ngx's, so from the same key the rows are ngx's and the
parameters differ only by float rounding; ``idx`` replaces the rows, for
a test.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import threefry as TF


def load_demos(path):
    """An ExpertDataset-layout ``.npz`` as ``(obs[N, D] float32,
    actions[N] int64)`` numpy arrays."""
    with np.load(path) as z:
        obs = np.asarray(z["obs"], np.float32)
        actions = np.asarray(z["actions"], np.int64).reshape(-1)
    assert obs.shape[0] == actions.shape[0], "obs/actions length mismatch"
    return obs, actions


def _cross_entropy(model, obs, actions):
    logits, _ = model(obs)
    ce = -F.log_softmax(logits, dim=-1).gather(1, actions[:, None]).mean()
    acc = (logits.argmax(-1) == actions).to(torch.float32).mean()
    return ce, acc


def pretrain(model, obs, actions, key=None, steps: int = 500,
             batch_size: int = 256, lr: float = 1e-3, idx=None):
    """Supervised pretrain of ``model``'s policy head on ``(obs,
    actions)``, in place on the model's device: ``steps`` Adam steps, each
    on ``min(batch_size, N)`` samples drawn with replacement on ngx's keys
    (``key`` a key tensor, or an int for ``key(int)``; ``key(0)`` when
    None, as ngx's): ``randint(k_t, (bs,), 0, N)`` for each ``k_t`` of
    ``split(key, steps)``, ngx's rows (``ngx/rl/bc.py:57-69``); or the
    rows ``idx[step]`` when ``idx`` (``int[steps, bs]``) is given.

    Returns ``(model, metrics)``: the final cross-entropy and accuracy over
    the whole set (``loss``, ``accuracy``) and the first and last
    minibatch losses."""
    dev = next(model.parameters()).device
    obs = torch.as_tensor(obs, dtype=torch.float32, device=dev)
    actions = torch.as_tensor(actions, dtype=torch.int64, device=dev)
    N = obs.shape[0]
    bs = min(batch_size, N)
    if idx is None:
        key = 0 if key is None else key
        idx = TF.randint(TF.split(TF.as_key(key, dev), steps), (bs,), 0, N)
    if not isinstance(idx, torch.Tensor):
        idx = torch.as_tensor(np.asarray(idx))
    idx = idx.to(device=dev, dtype=torch.int64)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses = []
    for rows in idx:
        opt.zero_grad(set_to_none=True)
        ce, _ = _cross_entropy(model, obs[rows], actions[rows])
        ce.backward()
        opt.step()
        losses.append(ce.detach())
    with torch.no_grad():
        full_ce, full_acc = _cross_entropy(model, obs, actions)
    return model, {"loss": float(full_ce), "accuracy": float(full_acc),
                   "first_loss": float(losses[0]),
                   "last_loss": float(losses[-1])}


def pretrain_from_npz(model, npz_path, **kw):
    """Load the ``.npz`` and :func:`pretrain` on it."""
    obs, actions = load_demos(npz_path)
    return pretrain(model, obs, actions, **kw)
