"""Utilities of the port: episode monitoring (:mod:`ngx_torch.utils.monitor`),
checkpoints (:mod:`ngx_torch.utils.checkpoint`) and the ``NGX_DEBUG``
invariant asserts (:mod:`ngx_torch.utils.debug`)."""

from .monitor import Monitor, load_results, ts2xy  # noqa: F401
from .checkpoint import restore_checkpoint, save_checkpoint  # noqa: F401
