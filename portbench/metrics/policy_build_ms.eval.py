"""Host milliseconds an evaluation spent making the policy's state dict an
``ActorCritic``: the program's ``ngx_torch.eval.policy`` spans over its
evaluations (its ``ngx_torch.eval.run`` spans) in the traced cycle."""

from portbench.spans import recorded


def read(ctx):
    builds = recorded(ctx, "ngx_torch.eval.policy")
    runs = recorded(ctx, "ngx_torch.eval.run")
    if not builds or not runs:
        return None
    return sum(s.host_ms for s in builds) / len(runs)
