"""The program's block-path spans, as their readers see them
(``blasted_tpu_torch/utils/profiling.py``): recorded only while a profiler
records, so in a run only the traced systems leave them.  A program
without them (one older than them) gives ``None`` here."""

from __future__ import annotations

from blasted_tpu_torch.utils import profiling

__all__ = ["span_count", "span_seconds"]


def _closed(run, names):
    records = getattr(profiling, "records", None)
    if run.trace is None or records is None:
        return []
    return [r for r in records()
            if r.name in names and r.end_ns is not None]


def span_count(run, name: str) -> int | None:
    """How many ``name`` spans the traced systems closed; ``None`` for
    none."""
    return len(_closed(run, (name,))) or None


def span_seconds(run, names) -> float | None:
    """Host seconds inside the spans named ``names`` in the traced
    systems; ``None`` where there are none."""
    recs = _closed(run, tuple(names))
    if not recs:
        return None
    return sum(r.end_ns - r.start_ns for r in recs) / 1e9
