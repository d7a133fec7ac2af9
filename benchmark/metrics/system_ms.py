"""system_ms: the measured window's seconds over the systems completed in
it, in ms (host clock; each system ends in a synchronise of the card)."""


def read(run):
    if not run.system_s:
        return None
    return run.window_s / len(run.system_s) * 1e3
