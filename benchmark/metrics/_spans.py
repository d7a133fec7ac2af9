"""The program's own spans and counters, as the readers of the per-layer
metrics see them (``blasted_tpu_torch/utils/profiling.py``).

The program records spans only while a profiler records, so in a run only
the traced systems leave records; counters are always on.  A program
without these spans or counters (one older than them) gives ``None`` here,
and its readers leave their metric out.
"""

from __future__ import annotations

from blasted_tpu_torch.utils import profiling

__all__ = ["iteration_split", "counter_mean"]


def iteration_split(run):
    """(iterations, ns in ``krylov.iter`` spans, ns in their ``sync.flag``
    children) over the traced systems; ``None`` without a traced window or
    without ``krylov.iter`` records."""
    records = getattr(profiling, "records", None)
    if run.trace is None or records is None:
        return None
    recs = records()
    iters = {i for i, r in enumerate(recs)
             if r.name == "krylov.iter" and r.end_ns is not None}
    if not iters:
        return None
    iter_ns = sum(recs[i].end_ns - recs[i].start_ns for i in iters)
    flag_ns = sum(r.end_ns - r.start_ns for r in recs
                  if r.name == "sync.flag" and r.parent in iters
                  and r.end_ns is not None)
    return len(iters), iter_ns, flag_ns


def counter_mean(name: str):
    """``counters[name + "_s"]`` over ``counters[name]``: mean host seconds
    a call; ``None`` where the program has no such counter."""
    counters = getattr(profiling, "counters", None)
    calls = (counters or {}).get(name, 0)
    if not calls:
        return None
    return counters[name + "_s"] / calls
