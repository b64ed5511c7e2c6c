"""The pool draw's share of its roofline, percent: the least time of one
draw (``yardstick.kernel_bound_ms`` of the stepping kernel at T 0 over
B x R rows, bytes: the fresh states written once) over the device time a
launch of the stepping kernel (``rollout_kernel``; the acting kernel
``train_rollout_kernel`` and ``policy_rollout_kernel`` excluded) in the
traced block (``torch.profiler``)."""

OTHERS = ("train_rollout_kernel", "policy_rollout_kernel")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or "pool_draw_bound_ms" not in ctx:
        return None
    hits = [e - s for name, s, e in tr.kernels if "rollout_kernel" in name
            and not any(o in name for o in OTHERS)]
    if not hits or sum(hits) <= 0:
        return None
    return 100.0 * ctx["pool_draw_bound_ms"] / (sum(hits) / 1e6 / len(hits))
