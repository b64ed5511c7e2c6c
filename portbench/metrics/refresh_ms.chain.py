"""The chain's stage play, milliseconds a refresh: ``PhaseTimer``'s
'refresh' phase over one block."""


def read(ctx):
    t = (ctx.get("phases") or {}).get("refresh")
    return 1e3 * sum(t) / len(t) if t else None
