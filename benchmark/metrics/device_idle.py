"""device_idle: the share of the traced window in which no kernel, copy or
set ran on the card, in %."""


def read(run):
    if run.trace is None or not run.trace["busy_s"]:
        return None
    busy = sum(run.trace["busy_s"].values()) / len(run.trace["busy_s"])
    return 100.0 * (1.0 - busy / run.trace["window_s"])
