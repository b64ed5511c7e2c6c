"""The PPO update's milliseconds an update: ``PhaseTimer``'s 'update'
phase (host clock after a device synchronize) over one block."""


def read(ctx):
    t = (ctx.get("phases") or {}).get("update")
    return 1e3 * sum(t) / len(t) if t else None
