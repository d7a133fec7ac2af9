"""Padded CSR/BSR kernels K9–K11: wrappers, plain twins, and the int32
index tables they read.

The general path of the JAX package (padded CSR/BSR storage, taken by any
matrix RCM cannot band and by ``prefer_dia: False``) has no ``pallas_call``:
its products and sweeps are XLA gathers and width reductions.  Each loop is
CUDA C++ here, in ``csrc/padded.cu``, templated on bs = 1…8; beside it
stands its plain PyTorch twin with the same contract (the same operations
in the same order, sentinel slots reading 0):

=====  =====================  =========================  ==================
K      wrapper                twin                       replaces (XLA)
=====  =====================  =========================  ==================
K9     padded_spmv            padded_spmv_ref            ``spmv``, ``bspmv``
K10 L  padded_lower_sweep     padded_lower_sweep_ref     ``unit_lower_``
                                                         ``sweep``
K10 U  padded_upper_sweep     padded_upper_sweep_ref     ``upper_solve_``
                                                         ``sweep``
K11    padded_factor_sweep    padded_factor_sweep_ref    ILU(0)'s factor
                                                         sweep
=====  =====================  =========================  ==================

A wrapper checks its operands and then dispatches on their device: a CPU
tensor runs the twin, a CUDA tensor launches the kernel (building it at the
first use), and any other device raises.  No CUDA call ever falls back to
the twin.  Launches are counted per kernel in ``_cuda.launches`` and per
kernel and card in ``_cuda.launches_by_device``.  Every output is a fresh
tensor.

Summation order.  A sum over a row's W slots (K11: over an entry's pairs)
runs in slot order and starts from the first product; a block product
``(bs, bs) · (bs)`` or ``(bs, bs) · (bs, bs)`` sums over j in order from
the j = 0 product (:func:`bmm`'s order).  The
JAX functions sum in XLA's order, so twin and JAX agree to rounding.

Index tables.  The kernels read int32 ids, built once per sparsity
pattern: ``sparse/csr.py::col_table`` for a padded matrix's column ids
(kept across ``with_new_vals``, so across ``update_values``) and
:class:`FactorSweepPlan` for the ILU pair lists (built with the
preconditioner's symbolic data).  The containers' own int64 fields, the
JAX package's, stay as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sparse.csr import col_table, extend_zero, take
from . import _cuda
from .stencil import _dcode

__all__ = [
    "MAX_BS", "col_table", "bmm", "padded_products",
    "padded_spmv", "padded_spmv_ref",
    "padded_lower_sweep", "padded_lower_sweep_ref",
    "padded_upper_sweep", "padded_upper_sweep_ref",
    "FactorSweepPlan", "padded_factor_sweep", "padded_factor_sweep_ref",
]

MAX_BS = 8      # the block sizes csrc/padded.cu instantiates: 1..8
_INT32_MAX = 2 ** 31 - 1


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched block products ``c[…, i, k] = Σ_j a[…, i, j]·b[…, j, k]``,
    summed over j in order from the j = 0 product, as bs broadcast
    products each the size of one operand (one (…, bs, bs, bs) product
    would hold bs times the pair gathers)."""
    c = a[..., :, 0:1] * b[..., 0:1, :]
    for j in range(1, a.shape[-1]):
        c = c + a[..., :, j:j + 1] * b[..., j:j + 1, :]
    return c


# ------------------------------------------------------------ operand checks

def _check(name: str, bs: int, floats: dict, ints: dict) -> torch.device:
    """Validate one call's operands: ``floats`` and ``ints`` map a name to
    ``(tensor, expected shape)``; the float operands share one dtype
    (float32/float64), the index operands are int32, every operand lies
    on one device and is contiguous.  Returns the device."""
    first = next(iter(floats.values()))[0]
    dtype, device = first.dtype, first.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {dtype} is not float32/float64")
    for group, want_dtype in ((floats, dtype), (ints, torch.int32)):
        for key, (t, shape) in group.items():
            if t.dtype != want_dtype or t.device != device:
                raise TypeError(f"{name}: {key} is {t.dtype} on {t.device}, "
                                f"expected {want_dtype} on {device}")
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: {key} has shape "
                                 f"{tuple(t.shape)}, expected {tuple(shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {key} is not contiguous")
    if device.type == "cuda" and not 1 <= bs <= MAX_BS:
        raise ValueError(f"{name}: block size {bs} is outside the kernel's "
                         f"1..{MAX_BS}")
    if device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel or twin for device {device}")
    return device


def _mv_shapes(name: str, vals: torch.Tensor, col: torch.Tensor,
               vectors: dict, dinv: torch.Tensor | None = None) -> None:
    """Validate a K9/K10 call: scalar ``vals`` (n, W) with (n,) vectors
    (and ``dinv``), or block (nb, W, bs, bs) with (nb, bs) vectors (and
    (nb, bs, bs) ``dinv``); ``col`` the int32 (rows, W) ids."""
    if vals.dim() == 2:
        bs = 1
    elif vals.dim() == 4 and vals.shape[2] == vals.shape[3]:
        bs = vals.shape[3]
    else:
        raise ValueError(f"{name}: vals has shape {tuple(vals.shape)}, "
                         "expected (n, W) or (nb, W, bs, bs)")
    rows, width = vals.shape[:2]
    vec = (rows,) if bs == 1 else (rows, bs)
    floats = {"vals": (vals, vals.shape)}
    floats.update({k: (t, vec) for k, t in vectors.items()})
    if dinv is not None:
        floats["dinv"] = (dinv, (rows,) if bs == 1 else (rows, bs, bs))
    _check(name, bs, floats, {"col": (col, (rows, width))})


def _launch_mv(name: str, mode: int, vals, col, x, rhs=None, dinv=None):
    """Launch K9 (mode 0) or K10 (1 lower, 2 upper) into a fresh output
    shaped like ``x``."""
    bs = 1 if vals.dim() == 2 else vals.shape[3]
    rows, width = vals.shape[:2]
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        _cuda.launch(name, "bt_padded_mv", x.device, bs, _dcode(x.dtype),
                     mode, vals.data_ptr(), col.data_ptr(), x.data_ptr(),
                     None if rhs is None else rhs.data_ptr(),
                     None if dinv is None else dinv.data_ptr(),
                     out.data_ptr(), rows, width)
    return out


# ------------------------------------------------------------- K9: SpMV ----

def padded_products(vals: torch.Tensor, col: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Σ_w vals[r, w]·x[col(r, w)] over the padded rows, the sentinel id
    reading 0: scalar ``vals`` (n, W), block (nb, W, bs, bs) against
    (nb, bs) segments, each block product summed over j in order, then the
    slots in order from the first."""
    xg = take(extend_zero(x), col.long())          # (n, W) or (nb, W, bs)
    if vals.dim() == 2:
        prods = vals * xg
    else:
        prods = vals[..., 0] * xg[..., None, 0]
        for j in range(1, vals.shape[-1]):
            prods = prods + vals[..., j] * xg[..., None, j]
    if prods.shape[1] == 0:
        return x.new_zeros(x.shape)
    acc = prods[:, 0]
    for w in range(1, prods.shape[1]):
        acc = acc + prods[:, w]
    return acc


def padded_spmv_ref(vals, col, x):
    """Twin of K9: ``y = Σ_w vals[·, w]·x[col(·, w)]``."""
    return padded_products(vals, col, x)


def padded_spmv(vals: torch.Tensor, col: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """K9: y = A x on a padded matrix's values ``vals`` ((n, W), or
    (nb, W, bs, bs) with (nb, bs) block vectors) and int32 column ids
    ``col`` (:func:`col_table`), into a fresh tensor."""
    _mv_shapes("padded_spmv", vals, col, {"x": x})
    if x.device.type == "cpu":
        return padded_spmv_ref(vals, col, x)
    return _launch_mv("padded_spmv", 0, vals, col, x)


# ------------------------------------------------- K10: apply sweeps ------

def padded_lower_sweep_ref(vals, col, rhs, x):
    """Twin of K10's lower mode: ``rhs − Σ_w vals[·, w]·x[col(·, w)]``."""
    return rhs - padded_products(vals, col, x)


def padded_upper_sweep_ref(vals, col, dinv, rhs, x):
    """Twin of K10's upper mode: ``dinv·(rhs − Σ …)``, scalar, or the block
    product ``D⁻¹_r (rhs − Σ …)`` with (nb, bs, bs) ``dinv``, summed over j
    in order."""
    t = rhs - padded_products(vals, col, x)
    if dinv.dim() == 1:
        return dinv * t
    out = dinv[..., 0] * t[:, None, 0]
    for j in range(1, dinv.shape[-1]):
        out = out + dinv[..., j] * t[:, None, j]
    return out


def padded_lower_sweep(vals, col, rhs, x) -> torch.Tensor:
    """K10, lower mode: one ``y ← z − L y`` Jacobi sweep (unit diagonal)
    with ``rhs`` = z, ``x`` = y, on the pre-masked strictly-lower factor
    ``vals`` in its padded layout; a fresh output (``rhs`` and ``x`` may be
    one tensor).  Every float operand has one dtype or this raises."""
    _mv_shapes("padded_lower_sweep", vals, col, {"rhs": rhs, "x": x})
    if x.device.type == "cpu":
        return padded_lower_sweep_ref(vals, col, rhs, x)
    return _launch_mv("padded_lower_sweep", 1, vals, col, x, rhs)


def padded_upper_sweep(vals, col, dinv, rhs, x) -> torch.Tensor:
    """K10, upper mode: one ``z ← U_ii⁻¹ (y − U z)`` sweep with ``rhs`` = y,
    ``x`` = z, on the pre-masked strictly-upper factor and the pre-inverted
    diagonal ``dinv`` ((n,), or (nb, bs, bs)); a fresh output."""
    _mv_shapes("padded_upper_sweep", vals, col, {"rhs": rhs, "x": x}, dinv)
    if x.device.type == "cpu":
        return padded_upper_sweep_ref(vals, col, dinv, rhs, x)
    return _launch_mv("padded_upper_sweep", 2, vals, col, x, rhs, dinv)


# ------------------------------------------------- K11: factor sweep ------

class FactorSweepPlan:
    """The static structure of one Chow–Patel sweep over the ILU(0) pair
    lists, built once per sparsity pattern (with the preconditioner's
    symbolic data, so kept across ``update_values``), int32 on the
    factor's device: ``ptr`` (nnz + 1), entry e's pairs at
    ``ptr[e] … ptr[e+1] − 1``; ``pl``, ``pu`` (npairs) the positions of
    each pair's l_ik and u_kc; ``dtab`` (nnz) −1 on and above the
    diagonal, else the row of the divisor source (scalar: the position of
    u_cc in the iterate; block: the column c, a row of the inverted
    diagonal blocks); ``nsrc`` the divisor source's rows and ``maxpairs``
    the longest list (the twin's loop count)."""

    def __init__(self, posptr, lowerp, upperp, dtab, nsrc: int, device):
        posptr = np.asarray(posptr)
        if posptr[-1] > _INT32_MAX or posptr.shape[0] - 1 > _INT32_MAX:
            raise ValueError(f"{int(posptr[-1])} pairs do not fit int32 ids")

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)) \
                .to(device)

        self.ptr, self.pl, self.pu = put(posptr), put(lowerp), put(upperp)
        self.dtab = put(dtab)
        self.nnz = posptr.shape[0] - 1
        self.nsrc = int(nsrc)
        self.maxpairs = int(np.diff(posptr).max(initial=0))


def padded_factor_sweep_ref(plan: FactorSweepPlan, base, ilu, dsrc):
    """Twin of K11: ``s_e = base_e − Σ_p ilu[pl_p]·ilu[pu_p]`` over entry
    e's pairs in list order from the first product (block products in
    :func:`bmm`'s order; ``s_e = base_e`` with no pair), then
    ``s_e / dsrc[dtab_e]`` (scalar) or ``s_e · dsrc[dtab_e]`` (block) where
    ``dtab_e ≥ 0``, else ``s_e``."""
    start = plan.ptr[:-1].long()
    cnt = plan.ptr[1:].long() - start
    block = base.dim() == 3
    mul = bmm if block else torch.mul

    def mask(m):
        return m[:, None, None] if block else m

    acc = None
    for p in range(plan.maxpairs):
        has = cnt > p
        q = torch.where(has, start + p, 0)
        prod = mul(take(ilu, take(plan.pl, q).long()),
                   take(ilu, take(plan.pu, q).long()))
        acc = torch.where(mask(has), prod if acc is None else acc + prod,
                          0.0 if acc is None else acc)
    s = base if acc is None else torch.where(mask(cnt > 0), base - acc, base)
    lower = plan.dtab >= 0
    d = take(dsrc, torch.where(lower, plan.dtab, 0).long())
    return torch.where(mask(lower), bmm(s, d) if block else s / d, s)


def padded_factor_sweep(plan: FactorSweepPlan, base: torch.Tensor,
                        ilu: torch.Tensor, dsrc: torch.Tensor) -> torch.Tensor:
    """K11: one Chow–Patel sweep of the flat ILU(0) iterate ``ilu``
    ((nnz,) or (nnzb, bs, bs)) over the (scaled) values ``base`` with
    ``plan``'s pair lists, into a fresh tensor.  ``dsrc`` is the previous
    iterate itself (scalar) or its inverted diagonal blocks (nb, bs, bs)."""
    bs = 1 if base.dim() == 1 else base.shape[-1]
    vshape = (plan.nnz,) if bs == 1 else (plan.nnz, bs, bs)
    sshape = (plan.nsrc,) if bs == 1 else (plan.nsrc, bs, bs)
    npairs = plan.pl.shape[0]
    device = _check("padded_factor_sweep", bs,
                    {"base": (base, vshape), "ilu": (ilu, vshape),
                     "dsrc": (dsrc, sshape)},
                    {"ptr": (plan.ptr, (plan.nnz + 1,)),
                     "pl": (plan.pl, (npairs,)), "pu": (plan.pu, (npairs,)),
                     "dtab": (plan.dtab, (plan.nnz,))})
    if device.type == "cpu":
        return padded_factor_sweep_ref(plan, base, ilu, dsrc)
    with torch.cuda.device(device):
        out = torch.empty_like(ilu)
        _cuda.launch("padded_factor_sweep", "bt_padded_factor_sweep", device,
                     bs, _dcode(ilu.dtype), plan.ptr.data_ptr(),
                     plan.pl.data_ptr(), plan.pu.data_ptr(),
                     plan.dtab.data_ptr(), base.data_ptr(), ilu.data_ptr(),
                     dsrc.data_ptr(), out.data_ptr(), plan.nnz)
    return out
