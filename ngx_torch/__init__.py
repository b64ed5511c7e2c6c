"""ngx_torch — the PyTorch / CUDA port of ngx, the batched NovelGridworlds
engine.

Imports torch and numpy, never jax.  It covers the 11 environments and the 13
novelty injections (:func:`inject_novelty`), PPO training under the
LidarInFront observation with the acting loop as a CUDA kernel written by hand
for Hopper (:mod:`ngx_torch.ops.train_rollout`, native or pool resets) and
the env-stepping kernel (:mod:`ngx_torch.ops.rollout`);
:func:`check_supported` names what it does not cover.  Its entry points run
on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .core.spec import EnvSpec, check_supported  # noqa: F401
from .core.state import EnvState, StepInfo  # noqa: F401
from .core.step import make_step  # noqa: F401
from .core.reset import counter_reset  # noqa: F401
from .novelty import NOVELTY_NAMES, inject_novelty  # noqa: F401
from .presets import SPEC_BUILDERS, make_spec  # noqa: F401
from .transforms import agent_map, lidar_in_front  # noqa: F401
