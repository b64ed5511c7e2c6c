"""ngx_torch — the PyTorch / CUDA port of ngx, the batched NovelGridworlds
engine.

Imports torch and numpy, never jax.  It covers the 11 environments and the 13
novelty injections (:func:`inject_novelty`), PPO training under the
LidarInFront observation with the acting loop as a CUDA kernel written by hand
for Hopper (:mod:`ngx_torch.ops.train_rollout`, native or pool resets) and
the env-stepping kernel (:mod:`ngx_torch.ops.rollout`), the curriculum
chain trainer (:mod:`ngx_torch.rl.curriculum`), batched evaluation
(:mod:`ngx_torch.rl.evaluate`), checkpoints, the training CLI
(``python -m ngx_torch.cli.train``), and the single-env Gym facade
(:mod:`ngx_torch.compat`) with the scripted experts and the drivers built
on it (``ngx_torch.cli.enjoy``, ``record_demos``, ``dagger``,
``keyboard_play``, ``socket_env`` / ``socket_agent``), the evaluation
report (``ngx_torch.cli.eval_agents``), the ``NGX_DEBUG=1`` invariant
asserts (:mod:`ngx_torch.utils.debug`), the Monitor CSV and its plots
(:mod:`ngx_torch.utils.monitor`, ``ngx_torch.cli.plot_results``) and the
trajectory recorder (:class:`ngx_torch.transforms.TrajectoryRecorder`):
a counterpart of every module of ngx, and the ``gym_novel_gridworlds``
drop-in surface over the facade (:mod:`ngx_torch.dropin`).  The plain path
and the CUDA kernels run every spec ngx's step runs, any number of item ids
and the NOOP op included (:func:`check_supported`); the kernels refuse only
a spec whose block outgrows the card's shared memory
(:func:`check_kernel_supported`).  Its entry points run on the card unless
the caller passes ``device="cpu"``.  The trainer, the chain, evaluation
(:mod:`ngx_torch.rl`), the drivers and the CLIs (``train``, ``enjoy``,
``record_demos``, ``dagger``, ``eval_agents``, ``perf``) draw from ngx's
keys only (:mod:`ngx_torch.ops.threefry`), so from the same arguments they
give ngx's results; the kernels and their plain twins (the stepping
functions, :class:`~ngx_torch.vector.VecEnv`, ``counter_reset``) draw by
the kernels' counter RNG unless asked for ngx's keys (``rng='threefry'``).
"""

__version__ = "0.1.0"

from .core.spec import (EnvSpec, check_kernel_supported,  # noqa: F401
                        check_supported)
from .core.state import EnvState, StepInfo  # noqa: F401
from .core.step import make_step  # noqa: F401
from .core.reset import counter_reset, make_reset  # noqa: F401
from .novelty import NOVELTY_NAMES, inject_novelty  # noqa: F401
from .presets import SPEC_BUILDERS, make_spec  # noqa: F401
from .transforms import agent_map, lidar_in_front  # noqa: F401
