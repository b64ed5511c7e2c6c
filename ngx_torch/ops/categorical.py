"""ngx's ``jax.random.categorical(key, logits)`` over a ``[B, A]`` batch of
logits from one key, as one CUDA launch (``csrc/categorical.cu``).

:func:`categorical` is what keyed evaluation (``rl/evaluate.py``
``make_eval``) and the chain's stage play (``rl/curriculum.py``) draw their
actions with.  On a CUDA tensor it launches the kernel, and raises where the
library refuses; elsewhere it is the plain twin,
:func:`ngx_torch.ops.threefry.categorical`, whose actions the kernel's equal
bit for bit on the card.  The key is read by the kernel from device memory
(no host read); the wrapper allocates only the output, launches on the
current stream and counts its launches in this module's ``launches``.
"""

from __future__ import annotations

import torch

from . import threefry as TF
from .tables import check_tensor

# the kernel's launches in this process (a plain integer)
launches = 0


def categorical(key, logits, *, lib=None) -> torch.Tensor:
    """int64 ``[B]``: row ``b``'s draw of ``jax.random.categorical(key,
    logits)`` over float32 ``logits[B, A]`` and one key (int64 ``[2]`` on
    the logits' device).  ``lib`` defaults to the built library, launched
    on the device's current stream (a test passes a host build of the
    device code and CPU tensors)."""
    global launches
    if lib is None and logits.device.type != "cuda":
        return TF.categorical(key, logits)
    if logits.dim() != 2:
        raise ValueError(f"logits: expected [B, A], got {tuple(logits.shape)}")
    n, n_actions = logits.shape
    if n * n_actions >= 2 ** 32:
        raise ValueError(f"the counters of {n} rows of {n_actions} actions "
                         "must lie in [0, 2^32)")
    logits = logits.contiguous()
    device = logits.device
    check_tensor(logits, "logits", torch.float32, (n, n_actions), device)
    check_tensor(key, "key", torch.int64, (2,), device)
    out = torch.empty((n,), dtype=torch.int64, device=device)
    if n == 0:
        return out
    stream = None
    if lib is None:
        from ._build import load_library
        lib = load_library()
        stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.ngx_categorical(key.data_ptr(), logits.data_ptr(), n, n_actions,
                             out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("categorical kernel launch failed: "
                           + lib.ngx_error_string(rc).decode())
    launches += 1
    return out
