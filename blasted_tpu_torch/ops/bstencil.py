"""Block-DIA stencil kernels K5, K6, K7 and K13 and the block inverse:
wrappers, plain twins, and the block factor's route rule.

Counterparts of the Pallas kernels of ``blasted_tpu/ops/bstencil.py`` and
of two functions the JAX package leaves to XLA, and K13, the block head
sweep: K7's first two sweeps of an apply chain from zero in one launch (in
JAX two sweeps of the ``fori_loop``).  Each kernel is CUDA C++ in
``csrc/bdia_stencil.cu``, templated on bs = 2…8 (K7, K13: 1…8); beside it
here stands its plain PyTorch twin with the same contract (the same
operations in the same order, the same exact ``0 → 1`` pivot guard, zero
reads beyond the ends):

=====  ========================  ====================  =====================
K      wrapper                   twin                  replaces
=====  ========================  ====================  =====================
K5     bdia_spmv_stencil         bdia_spmv_ref         ``_bspmv_call``
K6     bdia_factor_stencil       bdia_factor_ref       ``_bfactor_call``
—      bdia_block_inverse        block_inverse_ref     ``gj_inverse_rows``
K7 L   bdia_lower_sweep_stencil  bdia_lower_sweep_ref  ``soa_unit_lower_sweep``
K7 U   bdia_upper_sweep_stencil  bdia_upper_sweep_ref  ``soa_upper_solve_sweep``
K13    bdia_head_sweep_stencil   bdia_head_sweep_ref   two K7 sweeps from zero
=====  ========================  ====================  =====================

The inverse and K7 are XLA work in the JAX package (``ops/bstencil.py`` and
``ops/bdia.py`` there), with no ``pallas_call``.

A wrapper checks its operands and then dispatches on their device: a CPU
tensor runs the twin, a CUDA tensor launches the kernel (building it at the
first use), and any other device raises.  No CUDA call ever falls back to
the twin.  Launches are counted per kernel, K6, K7 and K13 per mode,
in ``_cuda.launches``, and per card in ``_cuda.launches_by_device``.

Operands are the container's own layout: block-diagonal values are
``(bs², nb)`` component slabs (row i·bs + j = block entry (i, j)), block
vectors ``(nb, bs)`` (K7, K13: ``(bs, nb)`` column streams, the apply's
layout).  K5, K7 and K13 read the factor's ``(k, bs², nb)`` data in place;
the Pallas kernels' restacking for TPU sublanes (``stack_spmv_coeffs``,
``stack_factor_coeffs``) and their padded frame have no counterpart.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import SEQUENTIAL, FactInit
from ..sparse.bdia import shift_last
from ..sparse.dia import shift_read
from . import _cuda
from .stencil import MAX_DIAGS, _dcode, factor_stencil_eligible

__all__ = [
    "MIN_BS", "MAX_BS",
    "bdia_spmv_stencil", "bdia_spmv_ref",
    "bdia_factor_stencil", "bdia_factor_ref",
    "bdia_block_inverse", "block_inverse_ref", "gj_inverse_rows",
    "soa_mv_streams", "soa_dinv_mul",
    "bdia_lower_sweep_stencil", "bdia_lower_sweep_ref",
    "bdia_upper_sweep_stencil", "bdia_upper_sweep_ref",
    "bdia_head_sweep_stencil", "bdia_head_sweep_ref",
    "bdia_factor_takes_compressed_route",
]

MIN_BS, MAX_BS = 2, 8    # the block sizes csrc/bdia_stencil.cu instantiates
SWEEP_MIN_BS = 1         # K7 and K13 also take bs = 1


# ------------------------------------------------------------ operand checks

def _check(name: str, bs: int, operands: dict,
           min_bs: int = MIN_BS) -> None:
    """Validate one call's operands: ``operands`` maps a name to
    ``(tensor, expected shape)``; the float operands share one dtype
    (float32/float64) and every operand one device; all are contiguous."""
    if not min_bs <= bs <= MAX_BS:
        raise ValueError(f"{name}: block size {bs} is outside the kernel's "
                         f"{min_bs}..{MAX_BS}")
    floats = [t for t, _ in operands.values() if t.dtype != torch.bool]
    dtype, device = floats[0].dtype, floats[0].device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {dtype} is not float32/float64")
    for key, (t, want) in operands.items():
        if t.device != device or (t.dtype != dtype and t.dtype != torch.bool):
            raise TypeError(f"{name}: {key} is {t.dtype} on {t.device}, "
                            f"expected {dtype} on {device}")
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(want)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
    if device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel or twin for device {device}")


def _offsets_arg(offsets):
    if len(offsets) > MAX_DIAGS:
        raise ValueError(f"{len(offsets)} offsets exceed {MAX_DIAGS}")
    return (ctypes.c_longlong * max(1, len(offsets)))(*offsets), len(offsets)


def _bs_of(b2: int) -> int:
    bs = int(round(b2 ** 0.5))
    if bs * bs != b2:
        raise ValueError(f"{b2} component streams is not a square block size")
    return bs


# ------------------------------------------------------------ K5: SpMV -----

def bdia_spmv_ref(offsets, data: torch.Tensor, x: torch.Tensor):
    """Twin of K5: ``y[r, i] = Σ_d Σ_j data[d, i·bs+j, r]·x[r+o_d, j]``,
    summed per output over d, then j (``soa_mv_streams``' order), with the
    block vector shifted once per diagonal."""
    nb, bs = x.shape
    acc = None
    for d, o in enumerate(offsets):
        xs = shift_read(x, o)                    # (nb, bs), block rows
        blk = data[d].view(bs, bs, nb)
        for j in range(bs):
            t = blk[:, j] * xs[:, j]             # (bs, nb): all i at once
            acc = t if acc is None else acc + t
    return acc.t().contiguous()


def bdia_spmv_stencil(offsets, data: torch.Tensor, x: torch.Tensor):
    """K5: block-DIA SpMV of the ``(k, bs², nb)`` data with the ``(nb, bs)``
    block vector ``x``."""
    if not offsets:
        raise ValueError("bdia_spmv_stencil: no diagonals")
    nb, bs = x.shape
    _check("bspmv", bs, {"x": (x, (nb, bs)),
                         "data": (data, (len(offsets), bs * bs, nb))})
    if x.device.type == "cpu":
        return bdia_spmv_ref(offsets, data, x)
    offs, k = _offsets_arg(offsets)
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        _cuda.launch("bspmv", "bt_bdia_spmv", x.device, offs, k, bs,
                     _dcode(x.dtype), data.data_ptr(), x.data_ptr(),
                     y.data_ptr(), nb)
    return y


# ------------------------------------------------- block Gauss–Jordan ------

def gj_inverse_rows(a: torch.Tensor, bs: int) -> torch.Tensor:
    """Batched pivoted Gauss–Jordan inverse over bs² component streams —
    the port of ``blasted_tpu.ops.bstencil.gj_inverse_rows`` on a
    ``(bs², ...)`` tensor, row operations done on whole ``(2·bs, ...)``
    rows of the augmented matrix [A | I] (per element the same steps).
    The pivot is the FIRST row holding the maximum of |M[r, col]|, r ≥ col
    (a where-chain; ``argmax`` picks the same for finite input); the pivot
    row is formed as ``0 + Σ_r where(hit_r, M[r], 0)`` and swapped with row
    col; a zero pivot is guarded to 1 (degenerate blocks invert to garbage
    the caller masks out); the row is scaled by ``1/d``.  The kernels run
    this elimination step for step (``gj_inverse`` in
    ``csrc/bdia_stencil.cu``)."""
    shape = a.shape[1:]
    blocks = a.reshape(bs, bs, *shape)
    eye = torch.eye(bs, dtype=a.dtype, device=a.device)
    eye = eye.reshape(bs, bs, *([1] * len(shape))).expand(bs, bs, *shape)
    M = [torch.cat([blocks[i], eye[i]]) for i in range(bs)]
    for col in range(bs):
        cand = [M[r][col].abs() for r in range(col, bs)]
        maxv = cand[0]
        for c in cand[1:]:
            maxv = torch.maximum(maxv, c)
        hit, found = [], None
        for c in cand:
            h = c == maxv if found is None else (c == maxv) & ~found
            hit.append(h)
            found = h if found is None else found | h
        piv = torch.zeros_like(M[col])
        for r in range(col, bs):
            piv = piv + torch.where(hit[r - col], M[r], 0.0)
        cur = M[col]
        for r in range(col, bs):
            M[r] = torch.where(hit[r - col], cur, M[r])
        one = torch.ones_like(piv[col])
        pn = piv * (one / torch.where(piv[col] == 0, one, piv[col]))
        for r in range(bs):
            M[r] = pn if r == col else M[r] - M[r][col] * pn
    return torch.stack([M[i][bs:] for i in range(bs)]).reshape(bs * bs,
                                                                 *shape)


def block_inverse_ref(a: torch.Tensor, mask: torch.Tensor | None = None):
    """Twin of the block inverse: ``gj_inverse_rows`` of the ``(bs², nb)``
    blocks, with the identity where ``mask`` (``(nb,)`` bool) is false."""
    bs = _bs_of(a.shape[0])
    if mask is not None:
        eye = torch.eye(bs, dtype=a.dtype, device=a.device).reshape(-1, 1)
        a = torch.where(mask, a, eye)
    return gj_inverse_rows(a, bs)


def bdia_block_inverse(a: torch.Tensor, mask: torch.Tensor | None = None):
    """Inverse of each ``(bs², nb)`` block, the identity where ``mask`` is
    false (``_soa_gj_inverse``): the kernel on CUDA, the twin on the CPU."""
    b2, nb = a.shape
    bs = _bs_of(b2)
    ops = {"a": (a, (b2, nb))}
    if mask is not None:
        if mask.dtype != torch.bool:
            raise TypeError("bdia_block_inverse: mask must be bool")
        ops["mask"] = (mask, (nb,))
    _check("block_inverse", bs, ops)
    if a.device.type == "cpu":
        return block_inverse_ref(a, mask)
    with torch.cuda.device(a.device):
        out = torch.empty_like(a)
        _cuda.launch("block_inverse", "bt_bdia_block_inverse", a.device, bs,
                     _dcode(a.dtype), a.data_ptr(),
                     None if mask is None else mask.data_ptr(),
                     out.data_ptr(), nb)
    return out


# ------------------------------------------------- K7: apply sweeps --------

def soa_mv_streams(data: torch.Tensor, offsets, sel, cols: torch.Tensor,
                   bs: int) -> torch.Tensor:
    """``y_i = Σ_{d∈sel} Σ_j data[d, i·bs+j]·x_j[·+off_d]`` as (bs, nb)
    column streams."""
    acc = None
    for d in sel:
        xs = shift_last(cols, offsets[d])
        blk = data[d].view(bs, bs, -1)
        for j in range(bs):
            t = blk[:, j] * xs[j]
            acc = t if acc is None else acc + t
    return torch.zeros_like(cols) if acc is None else acc


def soa_dinv_mul(dinv: torch.Tensor, cols: torch.Tensor,
                 bs: int) -> torch.Tensor:
    """Pre-inverted diagonal-block product: ``z_i = Σ_j dinv[i·bs+j]·t_j``."""
    blk = dinv.view(bs, bs, -1)
    acc = blk[:, 0] * cols[0]
    for j in range(1, bs):
        acc = acc + blk[:, j] * cols[j]
    return acc


def bdia_lower_sweep_ref(data, offsets, lower, z_cols, y_cols):
    """Twin of K7's lower mode: one ``y ← z − L y`` sweep on (bs, nb)
    column streams, unit block diagonal (reference: kernels_ilu_apply.hpp
    block_unit_lower_triangular, :54-67)."""
    bs = z_cols.shape[0]
    return z_cols - soa_mv_streams(data, offsets, lower, y_cols, bs)


def bdia_upper_sweep_ref(data, dinv, offsets, upper, y_cols, z_cols):
    """Twin of K7's upper mode: one ``z ← U_ii⁻¹ (y − U z)`` sweep on
    (bs, nb) column streams, diagonal pre-inverted (reference:
    kernels_ilu_apply.hpp block_upper_triangular, :79-94)."""
    bs = y_cols.shape[0]
    uz = soa_mv_streams(data, offsets, upper, z_cols, bs)
    return soa_dinv_mul(dinv, y_cols - uz, bs)


def _sweep_check(name: str, data, offsets, sel, vectors: dict, dinv):
    """Validate one K7 or K13 call: ``data`` (k, bs², nb) with
    k = len(offsets) ≤ 128, ``sel`` indices into it, the (bs, nb) column
    streams ``vectors`` and ``dinv`` (bs², nb) in the upper mode."""
    if len(offsets) > MAX_DIAGS:
        raise ValueError(f"{name}: {len(offsets)} diagonals exceed "
                         f"{MAX_DIAGS}")
    first = next(iter(vectors.values()))
    if first.dim() != 2:
        raise ValueError(f"{name}: column streams have shape "
                         f"{tuple(first.shape)}, expected (bs, nb)")
    bs, nb = first.shape
    ops = {key: (t, (bs, nb)) for key, t in vectors.items()}
    ops["data"] = (data, (len(offsets), bs * bs, nb))
    if dinv is not None:
        ops["dinv"] = (dinv, (bs * bs, nb))
    _check(name, bs, ops, min_bs=SWEEP_MIN_BS)
    if any(not 0 <= d < len(offsets) for d in sel):
        raise ValueError(f"{name}: diagonal indices {list(sel)} outside "
                         f"0..{len(offsets) - 1}")


def _sweep_launch(name: str, entry: str, data, offsets, sel, dinv, rhs,
                  *x):
    """Launch K7 or K13 (``entry``; the mode is ``dinv``'s presence) into
    a fresh output; ``rhs`` is z (lower) or y (upper), ``x`` K7's shifted
    operand (K13 has none)."""
    bs, nb = rhs.shape
    idx = (ctypes.c_int * max(1, len(sel)))(*sel)
    offs = (ctypes.c_longlong * max(1, len(sel)))(*(offsets[d] for d in sel))
    with torch.cuda.device(rhs.device):
        out = torch.empty_like(rhs)
        _cuda.launch(name, entry, rhs.device, idx, offs, len(sel),
                     bs, _dcode(rhs.dtype), int(dinv is not None),
                     data.data_ptr(),
                     None if dinv is None else dinv.data_ptr(),
                     rhs.data_ptr(), *(t.data_ptr() for t in x),
                     out.data_ptr(), nb)
    return out


def bdia_lower_sweep_stencil(data, offsets, lower, z_cols, y_cols):
    """K7, lower mode: one ``y ← z − L y`` sweep over the block diagonals
    ``lower`` (indices into ``data``, the factor's ``(k, bs², nb)`` slabs
    at ``offsets``) on ``(bs, nb)`` column streams, into a fresh
    ``(bs, nb)`` tensor, so the output never aliases an operand (``z_cols``
    and ``y_cols`` may be one tensor).

    Every operand has one dtype, float32 or float64, or this raises.  The
    dtype rule of the apply, as K2's (``ops/sweeps.py``): a factor stored
    in another dtype than the vectors' (``apply_dtype``) never reaches
    this wrapper; ``ops/bdia.py::soa_unit_lower_sweep`` computes the twin's
    products for it, so such an apply launches no K7."""
    _sweep_check("bdia_lower_sweep", data, offsets, lower,
                 {"z": z_cols, "y": y_cols}, None)
    if z_cols.device.type == "cpu":
        return bdia_lower_sweep_ref(data, offsets, lower, z_cols, y_cols)
    return _sweep_launch("bdia_lower_sweep", "bt_bdia_sweep", data, offsets,
                         lower, None, z_cols, y_cols)


def bdia_upper_sweep_stencil(data, dinv, offsets, upper, y_cols, z_cols):
    """K7, upper mode: one ``z ← U_ii⁻¹ (y − U z)`` sweep over the block
    diagonals ``upper`` with the pre-inverted diagonal blocks ``dinv``
    (``(bs², nb)``), into a fresh ``(bs, nb)`` tensor.  The
    operands' contract and the dtype rule are the lower mode's
    (:func:`bdia_lower_sweep_stencil`; ``soa_upper_solve_sweep``)."""
    _sweep_check("bdia_upper_sweep", data, offsets, upper,
                 {"y": y_cols, "z": z_cols}, dinv)
    if y_cols.device.type == "cpu":
        return bdia_upper_sweep_ref(data, dinv, offsets, upper, y_cols, z_cols)
    return _sweep_launch("bdia_upper_sweep", "bt_bdia_sweep", data, offsets,
                         upper, dinv, y_cols, z_cols)


# ------------------------------------------------- K13: head sweep ---------

def bdia_head_sweep_ref(data, offsets, sel, rhs_cols, dinv=None):
    """Twin of K13: K7's twin on the iterate that K7's first sweep from
    zero yields, ``rhs`` (lower) or ``dinv · rhs`` (upper, with ``dinv``)."""
    if dinv is None:
        return bdia_lower_sweep_ref(data, offsets, sel, rhs_cols, rhs_cols)
    x = soa_dinv_mul(dinv, rhs_cols, rhs_cols.shape[0])
    return bdia_upper_sweep_ref(data, dinv, offsets, sel, rhs_cols, x)


def bdia_head_sweep_stencil(data, offsets, sel, rhs_cols, dinv=None):
    """K13, the block head sweep: the second of two K7 sweeps from a zero
    iterate, in one launch.  Without ``dinv`` the lower mode,
    ``z − L z`` over the block diagonals ``sel``; with it the upper mode,
    ``U_ii⁻¹ (y − U x)`` with ``x = U_ii⁻¹ y`` recomputed for each
    neighbour.  On finite factors it equals those two K7 sweeps bit for
    bit, up to the sign of a zero.  The operands' contract, the fresh
    output and the device rule are K7's (:func:`bdia_lower_sweep_stencil`);
    counted as ``bdia_head_lower_sweep`` or, with ``dinv``,
    ``bdia_head_upper_sweep``."""
    _sweep_check("bdia_head_sweep", data, offsets, sel, {"rhs": rhs_cols},
                 dinv)
    if rhs_cols.device.type == "cpu":
        return bdia_head_sweep_ref(data, offsets, sel, rhs_cols, dinv)
    name = "bdia_head_lower_sweep" if dinv is None \
        else "bdia_head_upper_sweep"
    return _sweep_launch(name, "bt_bdia_head_sweep", data, offsets, sel, dinv,
                         rhs_cols)


# ------------------------------------------------- K6: compressed factor ----

def bdia_factor_ref(pair_offsets, base0: torch.Tensor, base_l: torch.Tensor,
                    ubs: torch.Tensor, dinv: torch.Tensor, out_dinv: bool):
    """Twin of K6: ``U0' = base0 − Σ_p (B_p·Dinv[·+o_p])·U_p`` (block
    products over ``(bs², nb)`` slabs, ``_contract_u0_chunk``'s order), and
    with ``out_dinv`` its block inverse ``gj_inverse_rows(U0')``."""
    b2, nb = base0.shape
    bs = _bs_of(b2)
    acc = base0.reshape(bs, bs, nb).clone()
    for p, o in enumerate(pair_offsets):
        B = base_l[p].view(bs, bs, nb)
        U = ubs[p].view(bs, bs, nb)
        D = shift_last(dinv, o).view(bs, bs, nb)
        tmp = B[:, 0:1] * D[0:1]                 # tmp[i, l] = Σ_k B[i,k]·D[k,l]
        for k in range(1, bs):
            tmp = tmp + B[:, k:k + 1] * D[k:k + 1]
        t = tmp[:, 0:1] * U[0:1]                 # t[i, j] = Σ_l tmp[i,l]·U[l,j]
        for l in range(1, bs):
            t = t + tmp[:, l:l + 1] * U[l:l + 1]
        acc = acc - t
    acc = acc.reshape(b2, nb)
    return gj_inverse_rows(acc, bs) if out_dinv else acc


def bdia_factor_stencil(pair_offsets, base0: torch.Tensor,
                        base_l: torch.Tensor, ubs: torch.Tensor,
                        dinv: torch.Tensor, out_dinv: bool) -> torch.Tensor:
    """K6: one compressed block Chow–Patel sweep.  ``base0`` and ``dinv``
    (the previous iterate's inverse diagonal) are ``(bs², nb)``, ``base_l``
    (the pair lowers' base values) and ``ubs`` (the pair uppers, pre-shifted
    by each pair's offset) ``(npair, bs², nb)``.  Returns the new diagonal
    U0' or, with ``out_dinv``, its inverse."""
    b2, nb = base0.shape
    bs = _bs_of(b2)
    npair = len(pair_offsets)
    _check("bfactor", bs, {"base0": (base0, (b2, nb)),
                           "dinv": (dinv, (b2, nb)),
                           "base_l": (base_l, (npair, b2, nb)),
                           "ubs": (ubs, (npair, b2, nb))})
    if base0.device.type == "cpu":
        return bdia_factor_ref(pair_offsets, base0, base_l, ubs, dinv,
                               out_dinv)
    offs, _ = _offsets_arg(pair_offsets)
    name = "bfactor_dinv" if out_dinv else "bfactor_u0"
    with torch.cuda.device(base0.device):
        out = torch.empty_like(base0)
        _cuda.launch(name, "bt_bdia_factor", base0.device, offs, npair, bs,
                     _dcode(base0.dtype), int(out_dinv), base0.data_ptr(),
                     base_l.data_ptr(), ubs.data_ptr(), dinv.data_ptr(),
                     out.data_ptr(), nb)
    return out


def bdia_factor_takes_compressed_route(offsets, pairs, nbuildsweeps: int,
                                       fact_init: FactInit) -> bool:
    """The block factor's route rule (ROADMAP.md C1).  True: the compressed
    sweeps; False: the plain per-sweep chain.

    K compressed sweeps equal 2K plain ones (the lowers 2K−1), so the route
    changes the numbers; the rule therefore reads only the problem and the
    options, never the device, and the CPU twins and the card compute the
    same factor.  It is the JAX package's condition
    (``blasted_tpu/precond/bdia_ilu0.py:367-369``) without its backend term.
    Unlike the scalar rule it has no mask term: inside the route a full
    diagonal mask takes K6 and any other mask the torch u0-state chain,
    which gives the same iterates.  FactInit.NONE warm starts stay plain
    (C2): the compressed chain rebuilds the lowers from the base values."""
    return (nbuildsweeps != SEQUENTIAL
            and factor_stencil_eligible(offsets, pairs)
            and fact_init != FactInit.NONE)
