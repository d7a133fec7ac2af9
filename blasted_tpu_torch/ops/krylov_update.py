"""K14: BiCGSTAB's vector updates in three fused passes: wrappers, plain
twins, and the rule that picks between them.

One BiCGSTAB iteration (``solvers/krylov.py::bicgstab``) updates its
vectors in three places, each a line of torch arithmetic that PyTorch runs
as a chain of elementwise kernels (14 kernels over 36 (n,) streams an
iteration).  K14 (``csrc/krylov_update.cu``) runs each line as one pass
over the 14 streams the mathematics needs; the JAX package leaves the same
lines to XLA, with no ``pallas_call``:

======  ===============  ===================  ==================================
pass    wrapper          twin                 computes
======  ===============  ===================  ==================================
p       p_update         p_update_ref         ``r + beta * p - bo * v``
s       s_update         s_update_ref         ``r - alpha * v``
x, r    xr_update        xr_update_ref        ``x + alpha * y + omega * z`` and
                                              ``s - omega * t``, or ``x`` and
                                              ``r`` where ``brk`` holds
======  ===============  ===================  ==================================

``bo`` is the 0-d ``beta * omega`` the solver computes.  Every scalar is a
0-d tensor on the vectors' device (``brk`` a bool); the kernels read them
there, so a launch reads nothing back to the host.  A twin is the solver's
own torch expression, so a kernel, its twin and the expressions they
replace agree to the last bit (``-fmad=false``, the same operations in the
same order).

Which runs is fixed by where the vectors lie: a tensor on a CUDA card
launches the kernel, after the operands are checked (float32 or float64,
one dtype, one device, one shape, contiguous; 0-d scalars of that dtype,
``brk`` bool), or raises; a CPU tensor, of any dtype, runs the twin.  A
row-sharded vector (:class:`~blasted_tpu_torch.parallel.mesh.ShardedVector`,
the distributed solvers') is updated shard by shard, each shard by that
rule, with every scalar copied to the shard's device as the vector's own
arithmetic copies it.  A launch runs on its operands' card, made the
current device for the call.  Each output is a fresh tensor: no operand is
written.  Launches are counted per pass and card in ``_cuda.launches``,
and each x-and-r update on the card, one an iteration however many shards
it spans, in the always-on counter ``krylov.fused_update``
(``utils/profiling.py``).
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import _cuda
from .blas1 import where

__all__ = ["p_update", "p_update_ref", "s_update", "s_update_ref",
           "xr_update", "xr_update_ref", "takes_kernel"]

# the C entry points' dtype codes
_DCODE = {torch.float32: 0, torch.float64: 1}


def takes_kernel(v: torch.Tensor) -> bool:
    """Whether K14 computes an update of the tensor ``v``: one on a CUDA
    card."""
    return v.device.type == "cuda"


def _check(name: str, vectors: tuple, scalars: tuple, flags=()) -> None:
    """The kernel's operands: ``vectors`` of the first's dtype (float32 or
    float64), device and shape, contiguous; ``scalars`` 0-d of that dtype
    on that device, and ``flags`` 0-d bools there."""
    first = vectors[0]
    dtype, device, shape = first.dtype, first.device, first.shape
    if dtype not in _DCODE:
        raise TypeError(f"{name}: dtype {dtype} is not float32/float64")
    for t in vectors:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype \
                or t.device != device or t.shape != shape:
            raise TypeError(f"{name}: the vectors must be {dtype} tensors of "
                            f"shape {tuple(shape)} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: a vector is not contiguous")
    for t, want in [*((s, dtype) for s in scalars),
                    *((f, torch.bool) for f in flags)]:
        if not isinstance(t, torch.Tensor) or t.dim() != 0 \
                or t.dtype != want or t.device != device:
            raise TypeError(f"{name}: a scalar must be a 0-d {want} tensor "
                            f"on {device}")


def _per_shard(update, vectors: tuple, scalars: tuple):
    """``update`` on each shard of the row-sharded ``vectors``, each 0-d
    scalar copied to the shard's device; the outputs (a vector, or a pair)
    as row-sharded vectors again."""
    outs = []
    for s, part in enumerate(vectors[0].parts):
        dev = part.device
        outs.append(update(*(v.parts[s] for v in vectors),
                           *(c if c.device == dev
                             else c.to(dev, non_blocking=True)
                             for c in scalars)))
    sharded = type(vectors[0])
    if isinstance(outs[0], tuple):
        return tuple(sharded(col) for col in zip(*outs))
    return sharded(outs)


# --------------------------------------------------------------- p pass ----

def p_update_ref(r, p, v, beta, bo):
    """Twin of K14's p pass: ``r + beta·p − bo·v``."""
    return r + beta * p - bo * v


def p_update(r, p, v, beta, bo):
    """BiCGSTAB's new direction ``r + beta·p − bo·v`` (``bo`` = beta·omega):
    4 streams on the card."""
    if not isinstance(r, torch.Tensor):
        return _per_shard(p_update, (r, p, v), (beta, bo))
    if not takes_kernel(r):
        return p_update_ref(r, p, v, beta, bo)
    _check("krylov_p_update", (r, p, v), (beta, bo))
    with torch.cuda.device(r.device):
        out = torch.empty_like(r)
        _cuda.launch("krylov_p_update", "bt_krylov_p_update", r.device,
                     _DCODE[r.dtype], r.data_ptr(), p.data_ptr(),
                     v.data_ptr(), beta.data_ptr(), bo.data_ptr(),
                     out.data_ptr(), r.numel())
    return out


# --------------------------------------------------------------- s pass ----

def s_update_ref(r, v, alpha):
    """Twin of K14's s pass: ``r − alpha·v``."""
    return r - alpha * v


def s_update(r, v, alpha):
    """BiCGSTAB's half-step residual ``s = r − alpha·v``: 3 streams on the
    card."""
    if not isinstance(r, torch.Tensor):
        return _per_shard(s_update, (r, v), (alpha,))
    if not takes_kernel(r):
        return s_update_ref(r, v, alpha)
    _check("krylov_s_update", (r, v), (alpha,))
    with torch.cuda.device(r.device):
        out = torch.empty_like(r)
        _cuda.launch("krylov_s_update", "bt_krylov_s_update", r.device,
                     _DCODE[r.dtype], r.data_ptr(), v.data_ptr(),
                     alpha.data_ptr(), out.data_ptr(), r.numel())
    return out


# ---------------------------------------------------------- x and r pass ----

def xr_update_ref(x, r, y, z, s, t, alpha, omega, brk):
    """Twin of K14's x-and-r pass: ``(x + alpha·y + omega·z, s − omega·t)``,
    or ``(x, r)`` where the 0-d flag ``brk`` holds."""
    x_new = x + alpha * y + omega * z
    r_new = s - omega * t
    return where(brk, x, x_new), where(brk, r, r_new)


def _xr_update(x, r, y, z, s, t, alpha, omega, brk):
    """``xr_update`` on tensors, uncounted."""
    if not takes_kernel(x):
        return xr_update_ref(x, r, y, z, s, t, alpha, omega, brk)
    _check("krylov_xr_update", (x, r, y, z, s, t), (alpha, omega), (brk,))
    with torch.cuda.device(x.device):
        x_out, r_out = torch.empty_like(x), torch.empty_like(r)
        _cuda.launch("krylov_xr_update", "bt_krylov_xr_update", x.device,
                     _DCODE[x.dtype], x.data_ptr(), r.data_ptr(),
                     y.data_ptr(), z.data_ptr(), s.data_ptr(), t.data_ptr(),
                     alpha.data_ptr(), omega.data_ptr(), brk.data_ptr(),
                     x_out.data_ptr(), r_out.data_ptr(), x.numel())
    return x_out, r_out


def xr_update(x, r, y, z, s, t, alpha, omega, brk):
    """BiCGSTAB's new iterate and residual, ``(x + alpha·y + omega·z,
    s − omega·t)``, or ``(x, r)`` kept where the breakdown flag ``brk``
    holds: 7 streams on the card (4 on breakdown)."""
    vectors, scalars = (x, r, y, z, s, t), (alpha, omega, brk)
    if isinstance(x, torch.Tensor):
        out, first = _xr_update(*vectors, *scalars), x
    else:
        out, first = _per_shard(_xr_update, vectors, scalars), x.parts[0]
    if takes_kernel(first):
        profiling.count("krylov.fused_update")
    return out
