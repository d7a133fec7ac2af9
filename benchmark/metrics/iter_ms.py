"""iter_ms: the Krylov spans' seconds over their iterations, in ms (host
clock)."""


def read(run):
    t = run.spans.get("krylov")
    if not t or not sum(run.iters):
        return None
    return sum(t) / sum(run.iters) * 1e3
