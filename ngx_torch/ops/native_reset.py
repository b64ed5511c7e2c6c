"""ngx's native reset on jax.random's keys as one CUDA launch
(``csrc/native_reset.cu``, device code in ``csrc/native_reset.cuh``).

:func:`native_reset` is what :func:`ngx_torch.core.reset.native_reset_state`
and :func:`~ngx_torch.core.reset.native_reset_where` run on a CUDA tensor,
for every spec they take; their plain twin,
:func:`~ngx_torch.core.reset.native_reset_plain`, runs on the CPU.  A row's
key comes from one of two sources:

* explicit keys ``[n, 2]`` (``make_reset``, ``KeyedVecEnv.reset`` and
  ``KeyedVecEnv.step(keys)``);
* a parent key ``[2]`` and a row offset: row ``b`` draws ``split_at(parent,
  b + offset)`` (``KeyedVecEnv.step_rows``, ``rollout``, ``scan``), so a
  shard or a scan's offset keeps ngx's rows.

With a step's state and its done mask the launch writes the carried state:
the done rows reset, the others copied from the stepped state.  That takes
the place of a ``nonzero`` (a host read), the keys' ``split_at``, the reset
and ``EnvState.put``.  The wrapper allocates the outputs with
``torch.empty``, launches on the current stream, raises where the library
refuses, and counts its launches in ``native_reset.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.state import EnvState
from .tables import check_tensor, kernel_tables

# EnvState's leaves in field order, with their dtype and trailing shape
LEAVES = (("map", torch.int32, "hw"), ("agent", torch.int32, 2),
          ("facing", torch.int32, None), ("inventory", torch.int32, "ni"),
          ("selected", torch.int32, None), ("step_count", torch.int32, None),
          ("last_action", torch.int32, None),
          ("last_reward", torch.float32, None),
          ("last_cost", torch.float32, None),
          ("last_done", torch.bool, None))


def _shapes(spec, n):
    width = {"hw": spec.map_size ** 2, "ni": spec.n_items}
    return [(name, dt, (n,) if w is None else (n, width.get(w, w)))
            for name, dt, w in LEAVES]


# the specs' table buffers (tables.py kernel_tables, no MLP widths) in
# pinned host memory, copied in for each launch without a host wait: the
# card keeps no buffer of the reset's between launches, so a run's memory
# peak is what the rest of the program holds
_host_tables = {}


def _table(spec, device):
    if spec.key not in _host_tables:
        t = torch.as_tensor(kernel_tables(spec))
        _host_tables[spec.key] = (t.pin_memory() if torch.cuda.is_available()
                                  else t)
    return _host_tables[spec.key].to(device, non_blocking=True)


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def native_reset(spec, keys=None, *, parent=None, offset: int = 0,
                 state=None, done=None, lib=None, stream=None) -> EnvState:
    """ngx's native reset of ``spec`` in one launch of the reset kernel.

    Without ``state``: the fresh states of ``keys`` (int64 ``[n, 2]``).
    With ``state`` (an :class:`EnvState` of ``B`` rows) and ``done`` (bool
    ``[B]``): the carried state, row ``b`` of ``state`` where ``done[b]``
    is false, else the reset of ``keys[b]`` (``keys`` ``[B, 2]``) or, with
    ``keys`` None, of ``split_at(parent, b + offset)`` (``parent`` int64
    ``[2]``).  Every tensor lies on one CUDA device.  ``lib`` and
    ``stream`` default to the built library and the device's current
    stream (a test passes a host build of the device code and CPU
    tensors)."""
    if state is None:
        if keys is None:
            raise ValueError("a reset without a state takes keys")
        device, n = keys.device, keys.shape[0] if keys.dim() == 2 else -1
    else:
        device, n = state.device, state.batch
        done = done.contiguous()
        check_tensor(done, "done", torch.bool, (n,), device)
    if keys is None:
        parent = parent.contiguous()
        check_tensor(parent, "parent", torch.int64, (2,), device)
    else:
        keys = keys.contiguous()
        check_tensor(keys, "keys", torch.int64, (n, 2), device)
    shapes = _shapes(spec, n)
    out = [torch.empty(shape, dtype=dt, device=device)
           for _, dt, shape in shapes]
    if n == 0:
        return EnvState(*out)
    if lib is None:
        from ._build import load_library
        lib = load_library()
        stream = torch.cuda.current_stream(device).cuda_stream
    ins = None
    if state is not None:
        ins = [getattr(state, name).contiguous() for name, _, _ in shapes]
        for t, (name, dt, shape) in zip(ins, shapes):
            check_tensor(t, name, dt, shape, device)
    tab = _table(spec, device)
    rc = lib.ngx_native_reset(
        tab.data_ptr(), n, spec.map_size ** 2, spec.n_items,
        keys.data_ptr() if keys is not None else None,
        parent.data_ptr() if keys is None else None, int(offset),
        done.data_ptr() if state is not None else None,
        _pointers(ins) if ins is not None else None, _pointers(out), stream)
    if rc != 0:
        raise RuntimeError("native reset kernel launch failed: "
                           + lib.ngx_error_string(rc).decode())
    native_reset.launches += 1
    return EnvState(*out)


native_reset.launches = 0
