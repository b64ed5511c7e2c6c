"""The yardstick's arithmetic: the card's peaks, a kernel's least time
(chip_smoke's ``bound``, copied) and the float32 MLP operations a PPO
update needs.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM and 67 TFLOP/s of
float32 outside the tensor cores (the precision the configurations state),
at the full 700 W."""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def kernel_bound_ms(map_size: int, n_items: int, dims, batch: int,
                    steps: int, source: str, pool_rows: int = 0,
                    words: int = 0):
    """``(ms, 'bytes' or 'operations')``: the least time of one launch of an
    acting ('train') or stepping ('prng', 'input') kernel: the state in and
    out (``words`` int32 words an env where it is written packed), the
    weights, the trajectory ('train'), the action stream ('input'), the
    pool and its bases, each once, over the HBM bandwidth; the MLP's
    float32 multiply-adds (2 operations each) over the float32 peak.

    Copied from ``chip_smoke.py``'s ``bound`` with one change: the kernels'
    table buffer (a few KiB, under 0.1% of the bytes here) is left out, so
    the bound does not read a layout of the program."""
    hw, ni = map_size ** 2, n_items
    state = batch * (words or hw + 7 + 2 + ni) * 4
    pairs = list(zip(dims[:-1], dims[1:]))
    params = sum(a * b + b for a, b in pairs) * 4
    nbytes = params + state
    if source == "train":
        nbytes += state + steps * batch * (dims[0] * 4 + 4 + 4 + 1)
        nbytes += pool_rows * (hw + ni + 4) * 4
        nbytes += 2 * batch * 4 if pool_rows else 0
    else:
        nbytes += batch * 8                  # reward sums, done counts
        nbytes += steps * batch * 4 if source == "input" else 0
    ops = 2 * sum(a * b for a, b in pairs) * batch * steps if dims else 0
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def forward_ops(dims) -> int:
    """Operations of one sample's forward pass through a tower of widths
    ``dims``."""
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def train_ops(dims) -> int:
    """One sample's forward and backward pass: the forward, the weights'
    gradients, and the inputs' gradients of every layer but the first."""
    first = 2 * dims[0] * dims[1]
    return 3 * forward_ops(dims) - first


def update_ops(obs_dim: int, hidden, n_actions: int, batch: int, steps: int,
               epochs: int, num_minibatches: int, bc_rows: int = 0) -> int:
    """The float32 operations one PPO train step needs: the acting forward
    of the policy tower over ``batch * steps`` samples, the value pass GAE
    needs (``batch * (steps + 1)``), every epoch's forward and backward of
    both towers over its minibatches, and the BC anchor's policy tower over
    ``bc_rows`` rows in each minibatch.  The recompute of ``logp`` is not
    counted."""
    pi = [obs_dim, *hidden, n_actions]
    v = [obs_dim, *hidden, 1]
    n = batch * steps
    used = (n // num_minibatches) * num_minibatches
    ops = n * forward_ops(pi) + batch * (steps + 1) * forward_ops(v)
    ops += epochs * used * (train_ops(pi) + train_ops(v))
    ops += epochs * num_minibatches * bc_rows * train_ops(pi)
    return ops
