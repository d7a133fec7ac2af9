"""Profiling: the program's spans and counters, over ``torch.profiler``.

Port of ``blasted_tpu/utils/profiling.py``, which wraps ``jax.profiler``
(the reference has no tracer: per-instance timers and gprof builds,
blasted_petsc.h:56-84).  :func:`trace` records the CPU and, where there is
one, the CUDA activity of a region and writes one Chrome trace file per
run into ``logdir``.

:func:`annotate` is the program's one span primitive.  It is on exactly
while a ``torch.profiler`` session records (one opened by :func:`trace` or
by any caller); nothing else switches it.  On, it enters a record function
named ``name`` (``torch._C._profiler._RecordFunctionFast``, the C++ core
of ``record_function`` without the Python dispatch that the profiler would
record as well), so the span lies in the profiler's own timeline, on the
device trace's clock, as a ``cpu_op`` event; and it appends a
:class:`Record` to a list in memory: the name, the start and end on the
host's ``perf_counter_ns``, the index of the enclosing record and a
request id (a span with no parent starts a new request, which its
children carry).  Past :data:`MAX_RECORDS` it appends nothing and counts
the drop instead.  Off, it returns one shared null context: no record, no
record function.  Records stay until :func:`reset`; :func:`records`
returns them.  On, a span costs ~2 µs of host (~0.9 µs the record
function, the rest the record), against ~10 µs through
``record_function``; off, ~0.3 µs (CPU measurements, torch 2.13).

The program's spans, each named after its layer:

- ``krylov.solve``: one call of a Krylov method (``solvers/krylov.py``);
- ``krylov.iter``: one iteration, in GMRES one Arnoldi step;
- ``sync.flag``: the host read of the iteration's done flag, inside
  ``krylov.iter``, where the host waits for the card to drain what the
  iteration queued;
- ``sync.result``: the final host reads that build ``SolveInfo``;
- ``precond.update``: ``Preconditioner.update_values``;
- ``precond.compute``: ``api.compute_preconditioner``;
- ``sync.timers``: the synchronisations of ``utils/timing.py``'s spans;
- ``precond.block_factor``, ``precond.block_inverse``: a block-DIA ILU(0)
  factor's sweeps and its final inverse diagonal blocks
  (``precond/bdia_ilu0.py``, ``compute``);
- ``precond.block_apply``: one apply of a block-DIA ILU(0) preconditioner;
- ``setup.bdia_from_bsr``: one call of ``sparse/bdia.py::try_bdia_from_bsr``.

:data:`counters` holds numbers that are always on, written by
:func:`count` (a dictionary add, ~0.2 µs on the CPU): at boundaries that
run once per call into the API, ``setup.dia_from_csr`` /
``setup.dia_from_csr_s`` (calls of ``sparse/dia.py::try_dia_from_csr`` and
their host seconds), ``setup.bdia_from_bsr`` / ``setup.bdia_from_bsr_s``
(the same of ``sparse/bdia.py::try_bdia_from_bsr``) and ``setup.precond`` /
``setup.precond_s`` (calls of
``api.setup_local_preconditioner``; their host seconds and those of each
context's first ``api.compute_preconditioner``, the factor that set-up
ends with); once per apply of a DIA ILU(0) preconditioner
(``precond/dia_ilu0.py``), ``precond.ilu_apply`` (every apply) and
``precond.zero_start`` (the applies whose chains start with the
zero-start sweep K12); once per apply of a block-DIA ILU(0)
preconditioner (``precond/bdia_ilu0.py``), ``precond.block_apply`` (every
apply) and ``precond.block_zero_start`` (the applies whose chains start
with the block head sweep K13).
Kernel launches are counted, and their host time summed, in
``ops/_cuda.py`` (``launches``, ``launch_ns``), not here.

Spans nest on one stack: the program calls them from one thread.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch

__all__ = ["trace", "annotate", "Record", "records", "dropped", "reset",
           "counters", "count", "MAX_RECORDS"]

#: The most records kept between two :func:`reset` calls (~100 bytes each).
MAX_RECORDS = 1_000_000

_profiler_enabled = torch._C._autograd._profiler_enabled
_RecordFunction = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()


@dataclass(slots=True)
class Record:
    """One span: host ns from ``time.perf_counter_ns`` (``end_ns`` None
    while open), ``parent`` the index in :func:`records` of the enclosing
    span (-1 for none) and ``request`` the id of its outermost span."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int
    request: int


_records: list = []
_open: list = []            # indices of the open spans, innermost last
_dropped = 0
_requests = 0

#: Always-on numbers by name (see the module docstring), cleared by
#: :func:`reset`.
counters: dict = {}


def count(name: str, value=1) -> None:
    """Add ``value`` to ``counters[name]``."""
    counters[name] = counters.get(name, 0) + value


def records() -> list:
    """The spans recorded since the last :func:`reset`, in the order they
    began."""
    return list(_records)


def dropped() -> int:
    """Spans not recorded since the last :func:`reset`: past
    :data:`MAX_RECORDS`."""
    return _dropped


def reset() -> None:
    """Clear the records, the drops, the request ids and :data:`counters`
    (call it outside any span)."""
    global _dropped, _requests
    _records.clear()
    _open.clear()
    counters.clear()
    _dropped = _requests = 0


class _Span:
    __slots__ = ("name", "_rf", "_rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped, _requests
        self._rf = _RecordFunction(self.name)
        self._rf.__enter__()
        index, self._rec = -1, None
        if len(_records) < MAX_RECORDS:
            parent = _open[-1] if _open else -1
            if parent >= 0:
                request = _records[parent].request
            else:
                request, _requests = _requests, _requests + 1
            index = len(_records)
            self._rec = Record(self.name, time.perf_counter_ns(), None,
                               parent, request)
            _records.append(self._rec)
        else:
            _dropped += 1
        _open.append(index)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec.end_ns = time.perf_counter_ns()
        if _open:
            _open.pop()
        self._rf.__exit__(*exc)
        return False


def annotate(name: str):
    """A span named ``name``: recorded while a profiler records, else one
    shared null context (see the module docstring)."""
    if not _profiler_enabled():
        return _NULL
    return _Span(name)


@contextlib.contextmanager
def trace(logdir: str | None):
    """Profile the region and write ``logdir/trace_<pid>_<ns>.json`` (a
    no-op when ``logdir`` is None).  Yields the profiler (None when off),
    so a caller can read ``key_averages()``.  The program's spans are on
    inside it and show in the file as ``cpu_op`` events."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
