"""The keyed draws on ngx's keys, milliseconds an update: ``PhaseTimer``'s
'permutation' phase, plus 'pool' where the step has one, over one block."""


def read(ctx):
    phases = ctx.get("phases") or {}
    t = phases.get("permutation")
    if not t:
        return None
    return 1e3 * (sum(t) + sum(phases.get("pool", []))) / ctx["updates"]
