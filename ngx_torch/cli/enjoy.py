"""Evaluation driver — the reference's ``enjoy.py`` rebuilt; the port of
``ngx/cli/enjoy.py``.

    python -m ngx_torch.cli.enjoy -env NovelGridworld-Pogostick-v1 \\
        -episodes 10 \\
        -ckpt trained_agents_torch/NovelGridworld-Pogostick-v1_solver/best.pt
    python -m ngx_torch.cli.enjoy -env NovelGridworld-v5 \\
        -ckpt trained_agents_torch/chain

Supports the reference's special v5 curriculum path (enjoy.py:58-100): for
``-env NovelGridworld-v5`` it chains v1→v2→v3→v4→v3 via state restore, using
a policy per stage where ``-ckpt`` holds one (``<env>.zip`` or
``<env>/best.pt``, the layout of ``trained_agents_torch/chain/``), else
random actions.

``-ckpt`` accepts a port checkpoint (:mod:`ngx_torch.utils.checkpoint`, an
``ActorCritic`` over the LidarInFront obs) or one of the reference's
stable-baselines-2 ``.zip`` files, read by :mod:`ngx_torch.rl.sb2` and run
over the env's own observation (the obs SB2 trained on, reference
tests/train.py:104-122).

The env is the single-env facade (:mod:`ngx_torch.compat`) on ``-device``,
``cuda`` by default; ngx runs these drivers on its CPU by default
(``-platform cpu``), which is ``-device cpu`` here.  A policy draws as
ngx's does (``ngx/cli/enjoy.py:66-80``), from ngx's keys
(:mod:`ngx_torch.ops.threefry`): the run starts from ``key(-seed)`` and
takes ``key, k = split(key)`` before each policy step, the action
``categorical(k, logits)`` over the ``[A]`` logits of one observation.
The keys and the draw stay on the host (one ``[A]`` row a step); the
logits are computed on ``-device``.  From the same arguments the episodes
are ngx's, up to a Gumbel near-tie between the port's logits and flax's
(they round otherwise).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..ops import threefry as TF

# ngx's drivers default to -platform cpu; the port's to the card
DEVICE_HELP = ("torch device (default cuda; -device cpu is ngx's default for "
               "this single-env driver, whose B=1 steps are launch-bound on "
               "the card)")


class Policy:
    """``policy(key, obs) -> int``, ngx's policy: one action for one
    observation, ``categorical(key, logits)`` over the ``[A]`` row of
    ``logits_fn(obs[1, D]) -> [1, A]`` on ``device``.  The key (an int64
    ``[2]`` of :func:`~ngx_torch.ops.threefry.key`'s words) and the draw
    stay on the host."""

    def __init__(self, logits_fn, device):
        self.logits_fn = logits_fn
        self.device = device

    def logits(self, obs) -> torch.Tensor:
        """The float32 ``[A]`` logits of one observation, on the host."""
        o = torch.as_tensor(np.asarray(obs, np.float32)[None],
                            device=self.device)
        with torch.no_grad():
            return self.logits_fn(o)[0].to(device="cpu",
                                            dtype=torch.float32)

    def __call__(self, key, obs) -> int:
        return int(TF.categorical(key, self.logits(obs)))


def model_policy(model, device) -> Policy:
    """A :class:`Policy` over an ``ActorCritic`` (or its state dict)."""
    from ..rl.evaluate import as_policy

    model = as_policy(model, device)
    return Policy(lambda o: model(o)[0], device)


def load_policy(ckpt, spec, device="cuda") -> Policy:
    """The :class:`Policy` of a port checkpoint (``ActorCritic`` of its
    config's ``hidden`` widths) or of an SB2 ``.zip``, on ``device`` (the
    card by default; it raises where there is none)."""
    from ..ops.tables import resolve_device
    from ..rl.models import ActorCritic
    from ..utils.checkpoint import restore_checkpoint

    device = resolve_device(device)
    if ckpt.endswith(".zip"):
        # a reference SB2 checkpoint (reference enjoy.py:49-72)
        from ..core.reset import counter_reset
        from ..core.step import make_step
        from ..rl.sb2 import check_dims, load_sb2_params, sb2_apply, \
            sb2_to_device

        params = sb2_to_device(load_sb2_params(ckpt), device)
        # fail with a clear shape error (not an opaque matmul error) when
        # the zip belongs to a different env — mirrors evaluate_sb2_zip
        obs0 = make_step(spec).get_obs(counter_reset(spec, 0, 0, 1, device))
        if isinstance(obs0, torch.Tensor):
            check_dims(params, int(obs0.shape[-1]), spec.n_actions, ckpt)
        return Policy(lambda o: sb2_apply(params, o)[0], device)

    tree = restore_checkpoint(ckpt, device=device)
    params = tree["params"]
    hidden = tuple(tree.get("config", {}).get("hidden", (64, 64)))
    model = ActorCritic(params["pi_0.weight"].shape[1], spec.n_actions,
                        hidden)
    model.load_state_dict(params)
    return model_policy(model, device)


def run_episodes(env, policy, episodes, cap, render, seed=0):
    """``episodes`` episodes of at most ``cap`` steps, episode ``ep`` reset
    after ``np.random.seed(seed + ep)``; random actions
    (``action_space.sample``) where ``policy`` is None, else
    ``policy(k, obs)`` with ``key, k = split(key)`` before each policy
    step from ``key(seed)``, as ngx's.  Returns the episodes' returns."""
    key = TF.key(seed)
    returns = []
    for ep in range(episodes):
        np.random.seed(seed + ep)
        obs = env.reset()
        total = 0.0
        for t in range(cap):
            if policy is None:
                a = env.action_space.sample()
            else:
                key, k = TF.split(key)
                a = policy(k, obs)
            obs, r, done, info = env.step(a)
            total += r
            if render:
                env.render()
            if done:
                break
        returns.append(total)
        print(f"episode {ep}: return={total:.1f} steps={t+1} "
              f"done={bool(done)}")
    print(f"mean return over {episodes} episodes: {np.mean(returns):.2f}")
    return returns


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-env", default="NovelGridworld-Bow-v0")
    p.add_argument("-episodes", type=int, default=10)
    p.add_argument("-episode_cap", type=int, default=100)
    p.add_argument("-ckpt", default="")
    p.add_argument("-render", action="store_true")
    p.add_argument("-num_beams", type=int, default=8)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-device", default="cuda", help=DEVICE_HELP)
    args = p.parse_args(argv)

    from .. import compat as C

    if args.env == "NovelGridworld-v5":
        # The reference's v5 curriculum (enjoy.py:58-100): the chain is
        # v1 -> v2 -> v3 (craft tree_tap) -> v4 -> v3 AGAIN (craft
        # pogo_stick), each stage restoring the previous env's terminal
        # state — v5 itself is never stepped.  Per-stage policies come from
        # ``-ckpt <dir>``: ``<env>.zip`` (the reference's SB2 agents) or a
        # port ``<env>/{best,final}.pt``; random actions otherwise.
        chain = ["NovelGridworld-v1", "NovelGridworld-v2",
                 "NovelGridworld-v3", "NovelGridworld-v4",
                 "NovelGridworld-v3"]
        prev = None
        for stage, env_id in enumerate(chain):
            env = C.make(env_id, env=prev, device=args.device)
            policy = None
            if args.ckpt:
                zipp = os.path.join(args.ckpt, env_id + ".zip")
                native = next(
                    (p for k in ("best.pt", "final.pt")
                     if os.path.exists(p := os.path.join(args.ckpt, env_id, k))),
                    None)
                if os.path.exists(zipp):
                    # SB2 agents act on the env's built-in lidar obs
                    policy = load_policy(zipp, env.spec, args.device)
                elif native:
                    # port agents act on the LidarInFront observation
                    env = C.LidarInFront(env, num_beams=args.num_beams)
                    policy = load_policy(native, env.spec, args.device)
            print(f"--- stage {stage}: {env_id} ---")
            run_episodes(env, policy, 1, args.episode_cap, args.render,
                         args.seed)
            prev = env
        return

    env = C.make(args.env, device=args.device)
    policy = None
    if args.ckpt:
        if not args.ckpt.endswith(".zip"):
            # port policies act on the LidarInFront observation; the
            # reference's SB2 zips act on the env's built-in obs (the legacy
            # envs' own lidar arrays — no wrapper, reference enjoy.py:49-56)
            env = C.LidarInFront(env, num_beams=args.num_beams)
        policy = load_policy(args.ckpt, env.spec, args.device)
    run_episodes(env, policy, args.episodes, args.episode_cap, args.render,
                 args.seed)


if __name__ == "__main__":
    main()
