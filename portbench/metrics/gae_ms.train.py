"""GAE and the episode tallies, milliseconds an update: ``PhaseTimer``'s
'gae' phase over one block."""


def read(ctx):
    t = (ctx.get("phases") or {}).get("gae")
    return 1e3 * sum(t) / len(t) if t else None
