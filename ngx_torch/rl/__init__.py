"""PPO for the batched engine — the port of ``ngx.rl``: the actor-critic
(:mod:`ngx_torch.rl.models`), and the trainer with its acting loop as a CUDA
kernel (:mod:`ngx_torch.rl.train`)."""

from .models import ActorCritic  # noqa: F401
from .train import PPOConfig, make_train, dryrun  # noqa: F401
