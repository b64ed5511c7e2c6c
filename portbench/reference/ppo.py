"""The PPO learner in plain torch: the recompute of logp and the value,
the solve-shaped reward, GAE, the epochs' permutations on the keys and the
minibatch update (clipped surrogate, value loss, entropy, the BC anchor,
optax's global-norm clip, Adam).

Frozen from the port's ``rl/train.py`` (``make_ppo_core`` without a mesh,
``make_learner``'s recompute and GAE, ``epoch_perms``, ``draw_seed``,
``clip_by_global_norm``).  :func:`learn` also hands back the first
minibatch's gradients as the optimizer took them, after the clip."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .frozen.ops import threefry as TF

SEED_HI = 2 ** 31 - 1


def draw_seed(key) -> int:
    """``randint(key, (), 0, 2^31 - 1)`` as a Python int."""
    return int(TF.randint(key, (), 0, SEED_HI))


def epoch_perms(epochs: int, key, n: int, device):
    """One ``permutation(key_e, n)`` per key of ``split(key, epochs)``."""
    return list(TF.permutation(TF.split(key, epochs).to(device), n))


def clip_by_global_norm(params, max_norm: float):
    """Every gradient ``(g / ||g||) * max_norm`` where ``||g|| >= max_norm``,
    no epsilon."""
    grads = [p.grad for p in params if p.grad is not None]
    g_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    trigger = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(trigger, g, (g / g_norm) * max_norm))


def gae(ppo, values, rewards, dones, last_value):
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    advs = torch.empty_like(values)
    for t in reversed(range(values.shape[0])):
        nonterm = 1.0 - dones[t].to(torch.float32)
        delta = rewards[t] + ppo["gamma"] * v_next * nonterm - values[t]
        adv_next = delta + ppo["gamma"] * ppo["gae_lambda"] * nonterm * adv_next
        advs[t] = adv_next
        v_next = values[t]
    return advs, advs + values


def loss_fn(ppo, model, obs, action, old_logp, adv, target, bc_data):
    logits, value = model(obs)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, action.long()[:, None])[:, 0]
    ratio = torch.exp(logp - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
    pg1 = ratio * adv_n
    pg2 = torch.clamp(ratio, 1 - ppo["clip_eps"], 1 + ppo["clip_eps"]) * adv_n
    pg_loss = -torch.minimum(pg1, pg2).mean()
    v_loss = 0.5 * torch.square(value - target).mean()
    entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=1).mean()
    total = pg_loss + ppo["vf_coef"] * v_loss - ppo["ent_coef"] * entropy
    if bc_data is not None and ppo.get("bc_coef", 0.0) > 0:
        bc_logits, _ = model(bc_data[0])
        bc_ce = -F.log_softmax(bc_logits, dim=-1).gather(
            1, bc_data[1][:, None]).mean()
        total = total + ppo["bc_coef"] * bc_ce
    return total, (pg_loss, v_loss, entropy)


def update(ppo, model, opt, batch, perms, bc_data=None, fault=None):
    """The epochs of minibatch steps.  Returns ``(pg, v, entropy)`` means and
    the first minibatch's clipped gradients.  ``fault='half'`` (a planted
    fault, for the checks) drops the second half of every minibatch."""
    obs, action, logp, adv, target = batch
    N = obs.shape[0]
    nm = ppo["num_minibatches"]
    mb = N // nm
    params = list(model.parameters())
    aux, first = [], None
    for perm in perms:
        idxs = perm.to(obs.device, torch.int64)[:mb * nm].reshape(nm, mb)
        for idx in idxs:
            if fault == "half":
                idx = idx[:mb // 2]
            opt.zero_grad(set_to_none=True)
            total, terms = loss_fn(ppo, model, obs[idx], action[idx],
                                   logp[idx], adv[idx], target[idx], bc_data)
            total.backward()
            clip_by_global_norm(params, ppo["max_grad_norm"])
            if first is None:
                first = [p.grad.detach().clone() for p in params]
            opt.step()
            aux.append(torch.stack([x.detach() for x in terms]))
    aux = torch.stack(aux)
    return aux.mean(0), first


def learn(ppo, spec, model, opt, rollout, last_obs, perms, bc_data=None,
          fault=None):
    """One step's learning from a rollout ``(obs_t, action, reward,
    done)``: recompute, the solve-shaped reward where the configuration
    asks for it, GAE, the update.  Returns ``(pg, v, entropy)`` and the
    first gradients."""
    obs_t, action, reward, done = rollout
    T, B = action.shape
    with torch.no_grad():
        logits, value = model(obs_t)
        logp = F.log_softmax(logits, dim=-1).gather(
            -1, action.long()[..., None])[..., 0]
        if ppo.get("solve_shaped"):
            solved = done & (reward > 0.5 * spec.reward_done)
            reward = torch.where(solved,
                                 torch.full_like(reward, spec.reward_done),
                                 torch.full_like(reward, -1.0))
        _, last_value = model(last_obs)
        adv, target = gae(ppo, value, reward, done, last_value)
    flat = (obs_t.reshape(T * B, -1), action.reshape(-1), logp.reshape(-1),
            adv.reshape(-1), target.reshape(-1))
    return update(ppo, model, opt, flat, perms, bc_data, fault)


def make_opt(ppo, model):
    return torch.optim.Adam(model.parameters(), lr=ppo["lr"], eps=1e-5)
