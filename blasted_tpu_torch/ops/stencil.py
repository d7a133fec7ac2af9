"""DIA-stencil kernels K1–K4, K8 and K12: wrappers, plain twins, and the
route rule.

Counterparts of the Pallas kernels of ``blasted_tpu/ops/stencil.py`` (K1–K4)
and of the plain Chow–Patel factor sweep that the JAX package leaves to XLA
(K8: ``dia_factor_sweep_tuple`` and ``dia_factor_sweep`` of
``blasted_tpu/precond/dia_ilu0.py``, no ``pallas_call``), and K12, the
zero-start sweep: K2's first two sweeps of an ILU(0) apply chain from zero
in one launch (in JAX two ``_tri_sweep_call`` launches).  Each kernel is
CUDA C++ in ``csrc/dia_stencil.cu``; beside it here stands its plain
PyTorch twin with the same contract (same operations in the same order, the
same exact ``0 → 1`` denominator guard, zero reads beyond the ends of the
vector):

====  ==========================  ======================  ===================
K     wrapper                     twin                    replaces
====  ==========================  ======================  ===================
K1    dia_spmv_stencil            dia_spmv_ref            ``_spmv_call``
K2    tri_sweep_stencil           tri_sweep_ref           ``_tri_sweep_call``
K3    factor_u0_stencil           factor_u0_ref           ``_factor_u0_call``
K4    factor_lower_stencil        factor_lower_ref        ``_factor_lower_``
                                                          ``call``
K8    plain_factor_sweep_stencil  plain_factor_sweep_ref  the plain sweep
                                                          (XLA)
K12   zero_start_sweep_stencil    zero_start_sweep_ref    two
                                                          ``_tri_sweep_call``
                                                          from zero
====  ==========================  ======================  ===================

A wrapper checks its operands and then dispatches on their device: a CPU
tensor runs the twin, a CUDA tensor launches the kernel (building it at the
first use), and any other device raises.  No CUDA call ever falls back to
the twin.  Launches are counted per kernel in ``_cuda.launches`` and per
kernel and card in ``_cuda.launches_by_device``.

The JAX kernels work in a padded vector frame with a VMEM halo ring; the
port has neither (see ``csrc/dia_stencil.cu``), so vectors here are plain
``(n,)`` tensors and coefficient streams are stacked ``(m, n)`` tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import SEQUENTIAL, FactInit
from ..sparse.dia import shift_read
from . import _cuda
from .blas1 import guard_zero

__all__ = [
    "dia_spmv_stencil", "dia_spmv_ref",
    "tri_sweep_stencil", "tri_sweep_ref",
    "zero_start_sweep_stencil", "zero_start_sweep_ref",
    "factor_u0_stencil", "factor_u0_ref",
    "factor_lower_stencil", "factor_lower_ref",
    "PlainSweepPlan", "plain_factor_sweep_stencil", "plain_factor_sweep_ref",
    "factor_stencil_eligible", "factor_takes_compressed_route",
    "stencil_plan", "dia_factor_sweeps_stencil",
]

MAX_DIAGS = 128     # BT_MAX_DIAGS of csrc/stencil_common.cuh


# ------------------------------------------------------------ operand checks

def _check(name: str, offsets, vectors: dict, streams: dict,
           n: int | None = None) -> int:
    """Validate one call's operands and return n (the first vector's
    length unless given).  ``vectors`` are (n,) tensors, ``streams``
    (len(offsets), n) tensors; all must share one dtype (float32/float64),
    one device, and be contiguous."""
    tensors = {**vectors, **streams}
    first = next(iter(tensors.values()))
    dtype, device = first.dtype, first.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {dtype} is not float32/float64")
    if len(offsets) > MAX_DIAGS:
        raise ValueError(f"{name}: {len(offsets)} diagonals exceed "
                         f"{MAX_DIAGS}")
    if n is None:
        n = next(iter(vectors.values())).shape[0]
    for key, t in tensors.items():
        if t.dtype != dtype or t.device != device:
            raise TypeError(f"{name}: {key} is {t.dtype} on {t.device}, "
                            f"expected {dtype} on {device}")
        want = (n,) if key in vectors else (len(offsets), n)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
    if device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel or twin for device {device}")
    return n


def _dcode(dtype) -> int:
    return 0 if dtype == torch.float32 else 1


def _launch(name: str, entry: str, offsets, out: torch.Tensor, n: int,
            ptrs) -> None:
    """Launch on ``out``'s card (the operands' device, checked by
    ``_check``) with its dtype."""
    offs = (ctypes.c_longlong * max(1, len(offsets)))(*offsets)
    _cuda.launch(name, entry, out.device, offs, len(offsets),
                 _dcode(out.dtype), *ptrs, n)


def _ptr(t):
    return None if t is None else t.data_ptr()


# ------------------------------------------------------------- K1: SpMV ----

def dia_spmv_ref(offsets, data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Twin of K1: ``y[i] = Σ_d data[d][i]·x[i+o_d]``, summed in order."""
    acc = data[0] * shift_read(x, offsets[0])
    for d in range(1, len(offsets)):
        acc = acc + data[d] * shift_read(x, offsets[d])
    return acc


def dia_spmv_stencil(offsets, data: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """K1: DIA SpMV over all diagonals of ``data`` (k, n)."""
    if not offsets:
        raise ValueError("dia_spmv_stencil: no diagonals")
    n = _check("dia_spmv", offsets, {"x": x}, {"data": data})
    if x.device.type == "cpu":
        return dia_spmv_ref(offsets, data, x)
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        _launch("dia_spmv", "bt_dia_spmv", offsets, y, n,
                (_ptr(data), _ptr(x), _ptr(y)))
    return y


# -------------------------------------------------- K2: triangular sweep ----

def tri_sweep_ref(offsets, coeff: torch.Tensor, rhs: torch.Tensor,
                  y: torch.Tensor, dinv: torch.Tensor | None = None):
    """Twin of K2: ``(rhs − Σ_j coeff[j]·y[·+o_j]) · (dinv | 1)``."""
    acc = rhs
    for j, o in enumerate(offsets):
        acc = acc - coeff[j] * shift_read(y, o)
    if dinv is not None:
        acc = acc * dinv
    return acc


def tri_sweep_stencil(offsets, coeff: torch.Tensor, rhs: torch.Tensor,
                      y: torch.Tensor, dinv: torch.Tensor | None = None):
    """K2: one Jacobi sweep on a triangular factor whose strictly
    triangular diagonals are ``coeff`` (m, n) at ``offsets``."""
    vectors = {"rhs": rhs, "y": y}
    if dinv is not None:
        vectors["dinv"] = dinv
    n = _check("tri_sweep", offsets, vectors, {"coeff": coeff})
    if y.device.type == "cpu":
        return tri_sweep_ref(offsets, coeff, rhs, y, dinv)
    with torch.cuda.device(y.device):
        out = torch.empty_like(y)
        _launch("tri_sweep", "bt_tri_sweep", offsets, out, n,
                (_ptr(coeff), _ptr(rhs), _ptr(dinv), _ptr(y), _ptr(out)))
    return out


# ------------------------------------------------- K12: zero-start sweep ----

def zero_start_sweep_ref(offsets, coeff: torch.Tensor, rhs: torch.Tensor,
                         dinv: torch.Tensor | None = None):
    """Twin of K12: K2's twin with the iterate its first sweep from zero
    yields, ``rhs`` (unit lower) or ``rhs · dinv`` (upper)."""
    y = rhs if dinv is None else rhs * dinv
    return tri_sweep_ref(offsets, coeff, rhs, y, dinv)


def zero_start_sweep_stencil(offsets, coeff: torch.Tensor, rhs: torch.Tensor,
                             dinv: torch.Tensor | None = None):
    """K12, the zero-start sweep: the second of two K2 sweeps from a zero
    iterate, in one launch, ``(rhs − Σ_j coeff[j]·y1[·+o_j]) · (dinv | 1)``
    with ``y1`` K2's first sweep from zero (``rhs``, or ``rhs · dinv`` with
    ``dinv``).  On finite factors it equals those two K2 sweeps bit for
    bit, up to the sign of a zero.  Counted as ``zero_start_lower_sweep``
    or, with ``dinv``, ``zero_start_upper_sweep``."""
    vectors = {"rhs": rhs}
    if dinv is not None:
        vectors["dinv"] = dinv
    n = _check("zero_start_sweep", offsets, vectors, {"coeff": coeff})
    if rhs.device.type == "cpu":
        return zero_start_sweep_ref(offsets, coeff, rhs, dinv)
    name = "zero_start_lower_sweep" if dinv is None \
        else "zero_start_upper_sweep"
    with torch.cuda.device(rhs.device):
        out = torch.empty_like(rhs)
        _launch(name, "bt_zero_start_sweep", offsets, out, n,
                (int(dinv is not None), _ptr(coeff), _ptr(rhs), _ptr(dinv),
                 _ptr(out)))
    return out


# ------------------------------------------------- K3/K4: compressed factor -

def factor_u0_ref(pair_offsets, base0: torch.Tensor, base_l: torch.Tensor,
                  ubs: torch.Tensor, u0: torch.Tensor) -> torch.Tensor:
    """Twin of K3: ``base0 − Σ_j (base_l[j] / guard(u0[·+o_j])) · ubs[j]``."""
    s = base0
    for j, o in enumerate(pair_offsets):
        s = s - (base_l[j] / guard_zero(shift_read(u0, o))) * ubs[j]
    return s


def factor_u0_stencil(pair_offsets, base0, base_l, ubs, u0) -> torch.Tensor:
    """K3: one compressed Chow–Patel sweep of the main diagonal."""
    n = _check("factor_u0", pair_offsets, {"base0": base0, "u0": u0},
               {"base_l": base_l, "ubs": ubs})
    if u0.device.type == "cpu":
        return factor_u0_ref(pair_offsets, base0, base_l, ubs, u0)
    with torch.cuda.device(u0.device):
        out = torch.empty_like(u0)
        _launch("factor_u0", "bt_factor_u0", pair_offsets, out, n,
                (_ptr(base0), _ptr(base_l), _ptr(ubs), _ptr(u0), _ptr(out)))
    return out


def factor_lower_ref(lower_offsets, base_l: torch.Tensor,
                     u0: torch.Tensor) -> torch.Tensor:
    """Twin of K4: ``l[j] = base_l[j] / guard(u0[·+o_j])``, stacked."""
    out = torch.empty_like(base_l)
    for j, o in enumerate(lower_offsets):
        out[j] = base_l[j] / guard_zero(shift_read(u0, o))
    return out


def factor_lower_stencil(lower_offsets, base_l, u0) -> torch.Tensor:
    """K4: the lower diagonals of the final compressed factor."""
    n = _check("factor_lower", lower_offsets, {"u0": u0}, {"base_l": base_l})
    if u0.device.type == "cpu":
        return factor_lower_ref(lower_offsets, base_l, u0)
    with torch.cuda.device(u0.device):
        out = torch.empty_like(base_l)
        _launch("factor_lower", "bt_factor_lower", lower_offsets, out, n,
                (_ptr(base_l), _ptr(u0), _ptr(out)))
    return out


# --------------------------------------------- K8: plain factor sweep -----

_PASS_THROUGH, _MASKED = 1, 2     # kPassThrough, kMasked of the kernel


class PlainSweepPlan:
    """The static structure of one plain Chow–Patel sweep on a (k, n) band,
    built once per preconditioner or shard and read by every sweep: the
    offsets, the pair lists ``pairs[d] = [(d_lower, d_upper, o1), ...]``,
    the main diagonal's index, which diagonals pass through unchanged and
    which re-mask, the (k, n) mask those read, and ``table``, the int64
    table K8 reads on the band's device (the first pair of each diagonal,
    the flags, then dl, du, o1 per pair; ``csrc/dia_stencil.cu``).

    ``mask`` is a (k, n) bool tensor, every diagonal re-masked (the stacked
    form, ``dia_factor_sweep``), or one (n,) bool tensor or ``None`` per
    diagonal (the tuple form's ``mask_t``: ``None``, no re-mask).  With
    ``prune`` the upper diagonals with no fill pairs pass through (the
    tuple form)."""

    def __init__(self, offsets, pairs, d0: int, mask, *, prune: bool,
                 device):
        k = len(offsets)
        if k > MAX_DIAGS:
            raise ValueError(f"plain_factor_sweep: {k} diagonals exceed "
                             f"{MAX_DIAGS}")
        self.offsets, self.d0 = tuple(offsets), d0
        self.pairs = tuple(tuple(p) for p in pairs)
        self.passthrough = tuple(prune and not pairs[d] and o > 0
                                 for d, o in enumerate(offsets))
        if isinstance(mask, torch.Tensor):
            self.masked = tuple(not p for p in self.passthrough)
            self.mask = mask if any(self.masked) else None
        else:
            self.masked = tuple(m is not None and not p
                                for m, p in zip(mask, self.passthrough))
            rows = [m for m, on in zip(mask, self.masked) if on]
            self.mask = torch.stack([
                m if on else torch.ones_like(rows[0])
                for m, on in zip(mask, self.masked)]) if rows else None
        flat = [x for d in range(k) if not self.passthrough[d]
                for pair in self.pairs[d] for x in pair]
        starts = [0]
        for d in range(k):
            starts.append(starts[-1] + (0 if self.passthrough[d]
                                        else len(self.pairs[d])))
        flags = [_PASS_THROUGH * p + _MASKED * m
                 for p, m in zip(self.passthrough, self.masked)]
        self.table = torch.tensor(starts + flags + flat, dtype=torch.int64,
                                  device=device)


def plain_factor_sweep_ref(plan: PlainSweepPlan, base: torch.Tensor,
                           ilu: torch.Tensor) -> torch.Tensor:
    """Twin of K8: one Chow–Patel sweep from ``ilu`` into a new (k, n)
    tensor, per diagonal ``base[d] − Σ ilu[dl]·ilu[du][·+o1]``, divided by
    ``guard(ilu[d0][·+o])`` below the diagonal, re-masked where the plan
    says; a pass-through diagonal is ``ilu[d]``."""
    udiag = ilu[plan.d0]
    out = []
    for d, o in enumerate(plan.offsets):
        if plan.passthrough[d]:
            out.append(ilu[d])
            continue
        s = base[d]
        for (dl, du, o1) in plan.pairs[d]:
            s = s - ilu[dl] * shift_read(ilu[du], o1)
        if o < 0:
            s = s / guard_zero(shift_read(udiag, o))
        out.append(torch.where(plan.mask[d], s, 0.0) if plan.masked[d]
                   else s)
    return torch.stack(out)


def plain_factor_sweep_stencil(plan: PlainSweepPlan, base: torch.Tensor,
                               ilu: torch.Tensor) -> torch.Tensor:
    """K8: one plain Chow–Patel sweep of the (k, n) iterate ``ilu`` over
    the band values ``base`` with ``plan``'s structure, into a fresh (k, n)
    tensor, so the output never aliases an operand (``base`` and ``ilu``
    may be one tensor).
    ``base`` and ``ilu`` have one dtype, float32 or float64, or this
    raises: a factor stored in ``apply_dtype`` never reaches it
    (``precond/dia_ilu0.py``)."""
    k = len(plan.offsets)
    if ilu.dim() != 2:
        raise ValueError(f"plain_factor_sweep: ilu has shape "
                         f"{tuple(ilu.shape)}, expected (k, n)")
    n = ilu.shape[1]
    _check("plain_factor_sweep", plan.offsets, {},
           {"base": base, "ilu": ilu}, n)
    tables = {"table": (plan.table, torch.int64, (plan.table.numel(),))}
    if plan.mask is not None:
        tables["mask"] = (plan.mask, torch.bool, (k, n))
    for key, (t, dtype, shape) in tables.items():
        if t.device != ilu.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"plain_factor_sweep: the plan's {key} is "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected contiguous {dtype} {shape} on "
                             f"{ilu.device}")
    if ilu.device.type == "cpu":
        return plain_factor_sweep_ref(plan, base, ilu)
    offs = (ctypes.c_longlong * k)(*plan.offsets)
    with torch.cuda.device(ilu.device):
        out = torch.empty_like(ilu)
        _cuda.launch("plain_factor_sweep", "bt_plain_factor_sweep",
                     ilu.device, offs, k, _dcode(ilu.dtype), plan.d0,
                     plan.table.data_ptr(), base.data_ptr(), ilu.data_ptr(),
                     _ptr(plan.mask), out.data_ptr(), n)
    return out


def factor_stencil_eligible(offsets, pairs) -> bool:
    """The compressed factor covers bands where ONLY the main diagonal
    carries fill pairs, each a lower × an upper — true for every
    tensor-product stencil (7/9/27-point)."""
    d0 = offsets.index(0)
    for d in range(len(offsets)):
        if d != d0 and pairs[d]:
            return False
    return all(offsets[dl] < 0 and offsets[du] > 0
               for (dl, du, _) in pairs[d0])


# JAX's TPU tile-plan constants (``blasted_tpu/ops/stencil.py:51-53``):
# the port keeps them only so that its factor route is JAX's; the card
# has no VMEM, and nothing here is tuned for the H100
_LANE = 1024
_NBUF = 4
_VMEM_BUDGET = 12 * 1024 * 1024
_HALO_WINDOW = 512 * 1024     # JAX's stencil_gate: 2·H·itemsize past it


def stencil_plan(offsets, n: int, itemsize: int = 4,
                 extra_streams: int = 0):
    """JAX's TPU tile plan (``blasted_tpu.ops.stencil.stencil_plan``):
    ``(T, n // T)`` when the band tiles into T = ⌈H/1024⌉·1024 rows that
    cover n at least twice and whose streams fit the 12 MiB VMEM budget,
    else ``None``.  Read by the route rule only."""
    H = max((abs(o) for o in offsets), default=0)
    if H == 0 or n < 4 * _LANE:
        return None
    T = -(-H // _LANE) * _LANE
    if n % T or n // T < 2:
        return None
    k = len(offsets) + extra_streams
    if (2 * k + _NBUF + 2 + 3) * T * itemsize > _VMEM_BUDGET:
        return None
    return T, n // T


def factor_takes_compressed_route(offsets, pairs, d0_mask_full: bool,
                                  nbuildsweeps: int, fact_init: FactInit,
                                  n: int, itemsize: int) -> bool:
    """The factor route rule (ROADMAP.md C1).  True: the compressed sweeps
    (K3, then K4 once); False: the plain per-sweep chain.

    The compressed route runs the contraction of TWO plain sweeps per
    configured sweep (after K sweeps u0 equals the plain chain after 2K,
    the lowers after 2K−1), so the route changes the numbers.  The rule
    therefore reads only the problem and the options, never the device:
    the CPU twins and the card compute the same factor.  It is the JAX
    package's condition on a TPU (``blasted_tpu/precond/dia_ilu0.py:
    217-223``): a halo window 2·H·itemsize past 512 KiB and a tile plan
    (``stencil_plan`` with 6 extra streams), on top of the band's shape
    and the options.  FactInit.NONE warm starts stay plain (C2): the
    compressed chain seeds its lowers from the base values only and would
    drop the previous factors."""
    H = max((abs(o) for o in offsets), default=0)
    return (nbuildsweeps != SEQUENTIAL
            and factor_stencil_eligible(offsets, pairs)
            and d0_mask_full
            and fact_init != FactInit.NONE
            and 2 * H * itemsize > _HALO_WINDOW
            and stencil_plan(offsets, n, itemsize, extra_streams=6)
            is not None)


def dia_factor_sweeps_stencil(offsets, pairs, d0: int, base: torch.Tensor,
                              ilu0: torch.Tensor, nsweeps: int) -> torch.Tensor:
    """Run ``nsweeps`` compressed Chow–Patel sweeps (K3) and materialise the
    lowers once from the second-to-last u0 iterate (K4) — the port of
    ``blasted_tpu.ops.stencil.dia_factor_sweeps_stencil`` without the
    padded frame.  ``base`` and ``ilu0`` are (k, n); returns a new (k, n)
    factor whose pair-free uppers pass through from ``ilu0``."""
    if nsweeps <= 0:
        return ilu0
    lowers = [d for d, o in enumerate(offsets) if o < 0]
    lower_offs = tuple(offsets[d] for d in lowers)
    pair_offs = tuple(o1 for (_, _, o1) in pairs[d0])
    # pair-uppers are fixed points: pre-shift them once for all sweeps
    base_pl = torch.stack([base[dl] for (dl, _, _) in pairs[d0]]) \
        if pairs[d0] else base[:0]
    ubs = torch.stack([shift_read(ilu0[du], o1) for (_, du, o1) in pairs[d0]]) \
        if pairs[d0] else base[:0]
    base0 = base[d0].contiguous()
    u0_prev = u0_last = ilu0[d0].contiguous()
    for _ in range(nsweeps):
        u0_prev, u0_last = u0_last, factor_u0_stencil(
            pair_offs, base0, base_pl, ubs, u0_last)
    # the two-array sweep updates the lowers from the PRE-sweep diagonal
    res = ilu0.clone()
    if lowers:
        res[lowers] = factor_lower_stencil(lower_offs, base[lowers], u0_prev)
    res[d0] = u0_last
    return res
