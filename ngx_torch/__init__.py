"""ngx_torch — the PyTorch / CUDA port of ngx, the batched NovelGridworlds
engine.

Imports torch and numpy, never jax.  This slice covers PPO training on the
modern-template presets under the LidarInFront observation, with the acting
loop as a CUDA kernel written by hand for Hopper
(:mod:`ngx_torch.ops.train_rollout`); :func:`check_supported` names what it
does not cover yet.
"""

__version__ = "0.1.0"

from .core.spec import EnvSpec, check_supported  # noqa: F401
from .core.state import EnvState, StepInfo  # noqa: F401
from .core.step import make_step  # noqa: F401
from .core.reset import counter_reset  # noqa: F401
from .presets import SPEC_BUILDERS, make_spec  # noqa: F401
from .transforms import agent_map, lidar_in_front  # noqa: F401
