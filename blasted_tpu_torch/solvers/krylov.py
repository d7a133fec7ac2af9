"""Krylov solvers: Richardson, BiCGSTAB, GCR, GMRES and CG.

Port of ``blasted_tpu/solvers/krylov.py`` (reference: tests/solvers.cpp
:90-352, tests/solvers.hpp:78-126).  The update order, the breakdown guards
and the iteration counting follow the JAX functions line by line; ``_nz``
there is :func:`~blasted_tpu_torch.ops.blas1.guard_zero` here (ROADMAP.md
C3).  JAX runs each loop as a ``lax.while_loop``; here it is a Python loop
that reads one flag on the host per iteration (per Arnoldi step in GMRES),
after the iteration that computed it, so it runs exactly the iterations the
JAX loop runs and reports the same counts (ROADMAP.md C5).  Where JAX runs
masked no-ops past the end (GMRES's remaining Arnoldi steps, GCR's restart
on the step that stops), the port leaves the loop instead: no reported
number depends on that work.

Solvers are right-preconditioned and see the operator and the
preconditioner only as callables on flat vectors: ``amat(x)`` and
``prec(r)``.  A vector is a tensor or a row-sharded vector of the
distributed solvers (:mod:`blasted_tpu_torch.parallel`): the solvers touch
vectors only through arithmetic and the ``ops.blas1`` helpers ``dot``,
``where`` and ``zeros_like``, as the JAX solvers run unchanged on sharded
arrays.  Every scalar stays a 0-d tensor of the vector's dtype on the
vector's device (the first shard's), as in JAX: host float64 scalars
would change float32 results.

Each method call is a ``krylov.solve`` span, each iteration (Arnoldi step
in GMRES) a ``krylov.iter`` span holding the ``sync.flag`` span of its
host read, and the reads that build ``SolveInfo`` a ``sync.result`` span
(``utils/profiling.py``; recorded only while a profiler records).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from ..ops.blas1 import dot, guard_zero, norm2, where, zeros_like
from ..ops.krylov_update import p_update, s_update, xr_update
from ..utils.profiling import annotate

__all__ = ["SolveInfo", "richardson", "bicgstab", "gcr", "cg", "gmres"]


class SolveInfo(NamedTuple):
    """(reference: tests/solvers.hpp SolveInfo.)  ``breakdown`` flags a
    Krylov breakdown (rho / rhat·v / t·t ≈ 0 in BiCGSTAB, p·Ap ≈ 0 in CG,
    q·q ≈ 0 in GCR, an annihilated Arnoldi column in GMRES): the solver
    stops with the last finite iterate."""

    converged: bool
    iters: int
    resnorm: float
    bnorm: float
    breakdown: bool = False


def _solve_span(method):
    """Run ``method`` inside a ``krylov.solve`` span."""
    @functools.wraps(method)
    def spanned(*args, **kwargs):
        with annotate("krylov.solve"):
            return method(*args, **kwargs)
    return spanned


def _finfo(b: torch.Tensor):
    finfo = torch.finfo(b.dtype)
    return finfo.eps, finfo.tiny


@_solve_span
def richardson(amat: Callable, prec: Callable, b: torch.Tensor,
               x0: torch.Tensor, tol: float = 1e-6, maxiter: int = 500):
    """Preconditioned Richardson iteration (reference: tests/solvers.cpp
    RichardsonSolver::solve, :90-133).  A step counts only when it is not
    the converged one (that pass is a ``krylov.iter`` span all the same);
    the final residual is recomputed for the report."""
    bnorm = norm2(b)
    x, step, done = x0, 0, False
    while step < maxiter and not done:
        with annotate("krylov.iter"):
            s = b - amat(x)
            resnorm = norm2(s)
            conv = resnorm / bnorm < tol
            dx = prec(s)
            x = where(conv, x, x + dx)
            with annotate("sync.flag"):
                done = bool(conv)                # one host sync per step
            step += 0 if done else 1
    resnorm = norm2(b - amat(x))
    with annotate("sync.result"):
        info = SolveInfo(converged=bool(resnorm / bnorm < tol), iters=step,
                         resnorm=float(resnorm), bnorm=float(bnorm))
    return x, info


@_solve_span
def bicgstab(amat: Callable, prec: Callable, b: torch.Tensor,
             x0: torch.Tensor, tol: float = 1e-6, maxiter: int = 500):
    """Right-preconditioned BiCGSTAB, same update sequence and iteration
    count (iters = steps taken, the breakdown step included) as the
    reference (tests/solvers.cpp BiCGSTAB::solve, :140-244), with breakdown
    guards on rho, rhat·v and t·t.  The vector updates of an iteration (p,
    s, and x with r) are ``ops/krylov_update.py``'s three passes: on a CUDA
    card the fused kernels K14, elsewhere the same torch expressions."""
    dt = b.dtype
    eps, tiny = _finfo(b)

    def scalar(v):
        return torch.tensor(v, dtype=dt, device=b.device)

    bnorm = norm2(b)
    r0 = b - amat(x0)
    rhat = r0
    nrhat = norm2(rhat)

    x, r = x0, r0
    p = zeros_like(b)
    v = zeros_like(b)
    rhoold, alpha, omega = scalar(1.0), scalar(1.0), scalar(1.0)
    resnorm = scalar(100.0)
    breakdown = torch.zeros((), dtype=torch.bool, device=b.device)
    step = 0
    done = False

    while step < maxiter and not done:
        with annotate("krylov.iter"):
            rho = dot(rhat, r)
            # breakdown: rhat ⟂ r structurally (an exact zero dot); an
            # eps-scale relative threshold would false-fire on f32 rounding
            # at large n
            brk = torch.abs(rho) <= eps * eps * nrhat * norm2(r) + 100 * tiny
            brk = brk | (torch.abs(rhoold * omega) <= 100 * tiny)
            # a zero denominator is a breakdown: guard_zero keeps the
            # quotient finite and brk discards the step
            beta = rho * alpha / guard_zero(rhoold * omega)
            p = p_update(r, p, v, beta, beta * omega)
            y = prec(p)
            v = amat(y)
            rv = dot(rhat, v)
            brk = brk | (torch.abs(rv)
                         <= eps * eps * nrhat * norm2(v) + 100 * tiny)
            alpha = rho / guard_zero(rv)
            rs = s_update(r, v, alpha)           # 's' of the algorithm
            z = prec(rs)
            t = amat(z)
            tt = dot(t, t)
            # t ≈ 0: the "lucky" half-step breakdown — x + αy is still
            # valid
            lucky = tt <= 100 * tiny
            omega = torch.where(lucky, torch.zeros_like(tt),
                                dot(t, rs) / guard_zero(tt))
            # on breakdown keep the previous finite iterate
            x, r = xr_update(x, r, y, z, rs, t, alpha, omega, brk)
            resnorm = torch.where(brk, resnorm, norm2(r))
            conv = resnorm / bnorm < tol
            breakdown = breakdown | brk | (lucky & ~conv)
            rhoold = rho
            step += 1
            with annotate("sync.flag"):
                done = bool(conv | brk | lucky)  # one host sync per step

    with annotate("sync.result"):
        resnorm_f, bnorm_f = float(resnorm), float(bnorm)
        info = SolveInfo(converged=bool(resnorm / bnorm < tol), iters=step,
                         resnorm=resnorm_f, bnorm=bnorm_f,
                         breakdown=bool(breakdown))
    return x, info


@_solve_span
def gcr(amat: Callable, prec: Callable, b: torch.Tensor, x0: torch.Tensor,
        tol: float = 1e-6, maxiter: int = 500, nrestart: int = 30):
    """Restarted GCR (≈ flexible GMRES), right-preconditioned (reference:
    tests/solvers.cpp GCR::solve, :252-352).  The bases P and Q are lists
    of ``nrestart`` vectors; a new direction is projected
    over the k+1 built rows only, each β taken from the unmodified q_new.
    At a restart the residual is recomputed from x.  On the step that stops
    the loop (converged, breakdown or maxiter) the JAX loop still builds the
    next direction or restarts, and discards it; the port does not."""
    tiny = _finfo(b)[1]
    bnorm = norm2(b)
    P = [None] * nrestart
    Q = [None] * nrestart

    def restart(x):
        res = b - amat(x)
        P[0] = prec(res)
        Q[0] = amat(P[0])
        return res

    x = x0
    res = restart(x)
    resnorm = norm2(res)
    breakdown = torch.zeros((), dtype=torch.bool, device=b.device)
    k, step, done = 0, 0, False
    while step < maxiter and not done:
        with annotate("krylov.iter"):
            pk, qk = P[k], Q[k]
            qq = dot(qk, qk)
            # breakdown: A·p_k ≈ 0 (the operator annihilated the
            # direction)
            brk = qq <= 100 * tiny
            alpha = dot(res, qk) / guard_zero(qq)
            x = where(brk, x, x + alpha * pk)
            res = where(brk, res, res - alpha * qk)
            resnorm = torch.where(brk, resnorm, norm2(res))
            step += 1
            conv = resnorm / bnorm < tol
            breakdown = breakdown | brk
            with annotate("sync.flag"):
                done = bool(conv | brk)          # one host sync per step
            if done or step >= maxiter:
                break
            if k == nrestart - 1:
                res = restart(x)
                k = 0
                continue
            z = prec(res)
            qn = amat(z)
            # β_l = −(q_new·q_l)/(q_l·q_l) for l ≤ k, from the unmodified
            # q_new
            pn, dq = z, zeros_like(z)
            for l in range(k + 1):
                ql = Q[l]
                beta = -dot(ql, qn) / guard_zero(dot(ql, ql))
                pn = pn + beta * P[l]
                dq = dq + beta * ql
            P[k + 1] = pn
            Q[k + 1] = qn + dq
            k += 1
    with annotate("sync.result"):
        info = SolveInfo(converged=bool(resnorm / bnorm <= tol), iters=step,
                         resnorm=float(resnorm), bnorm=float(bnorm),
                         breakdown=bool(breakdown))
    return x, info


@_solve_span
def gmres(amat: Callable, prec: Callable, b: torch.Tensor, x0: torch.Tensor,
          tol: float = 1e-6, maxiter: int = 500, nrestart: int = 30):
    """Restarted GMRES(m), right-preconditioned, with Givens rotations (the
    standard Saad formulation, as the JAX package has it).  ``iters`` is the
    sum of the columns built over the cycles; a cycle builds all m columns
    whatever ``maxiter`` says, which is checked between cycles only.  The
    Hessenberg matrix, the rotations and g are tensors of the vector's dtype
    on its device.  ``converged`` is decided on the recomputed true
    residual against tol·1.01."""
    m = nrestart
    dt, dev = b.dtype, b.device
    tiny = _finfo(b)[1]
    eps = torch.tensor(1e-30, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    bnorm = norm2(b)
    V = [None] * (m + 1)

    def arnoldi_cycle(x):
        r = b - amat(x)
        beta = norm2(r)
        V[0] = r / torch.maximum(beta, eps)
        H = torch.zeros((m + 1, m), dtype=dt, device=dev)
        cs, sn = [], []
        g = [beta] + [zero] * m
        k, done, brk = 0, False, False
        for j in range(m):
            with annotate("krylov.iter"):
                w = amat(prec(V[j]))
                # modified Gram-Schmidt over the j+1 built rows, w updated
                # between projections
                hcol = [zero] * (m + 1)
                for i in range(j + 1):
                    vi = V[i]
                    hi = dot(vi, w)
                    w = w - hi * vi
                    hcol[i] = hi
                hnext = norm2(w)
                V[j + 1] = w / torch.maximum(hnext, eps)
                hcol[j + 1] = hnext
                # the previous Givens rotations on the new column
                for i in range(j):
                    hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                    hip = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                    hcol[i], hcol[i + 1] = hi, hip
                # the new rotation annihilating hcol[j+1]
                denom = torch.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
                c = hcol[j] / torch.maximum(denom, eps)
                sgn = hcol[j + 1] / torch.maximum(denom, eps)
                hj = c * hcol[j] + sgn * hcol[j + 1]
                hcol[j], hcol[j + 1] = hj, zero
                g[j + 1] = -sgn * g[j]
                g[j] = c * g[j]
                H[:, j] = torch.stack(hcol)
                cs.append(c)
                sn.append(sgn)
                # Arnoldi breakdown: the new column annihilated entirely
                # (hnext ≈ 0 and the rotated pivot ≈ 0, a structurally
                # singular operator); a happy breakdown (hnext ≈ 0, hj ≠ 0)
                # converges
                brk_t = (hnext <= 100 * tiny) \
                    & (torch.abs(hj) <= 100 * tiny)
                done_t = (torch.abs(g[j + 1]) / bnorm < tol) | brk_t
                k += 1
                # one host sync per Arnoldi step: done, then brk
                with annotate("sync.flag"):
                    done = bool(done_t)
                    brk = done and bool(brk_t)
                if done:
                    break
        # back-substitution on the k×k upper-triangular H
        y = torch.zeros((m,), dtype=dt, device=dev)
        for i in range(k - 1, -1, -1):
            num = g[i] - torch.sum(H[i, :] * y)
            hii = H[i, i]
            y[i] = num / torch.where(hii == 0, torch.ones_like(hii), hii)
        # combine the k built basis rows
        xsum = zeros_like(b)
        for i in range(k):
            xsum = xsum + y[i] * V[i]
        return x + prec(xsum), k, done, brk

    r0 = norm2(b - amat(x0))
    x, step, breakdown = x0, 0, False
    done = bool(r0 / bnorm < tol)
    while step < maxiter and not done:
        # the cycle's last done flag is the outer test
        # (|g[k]|/‖b‖ < tol) | brk of the JAX loop
        x, k, done, brk = arnoldi_cycle(x)
        step += k
        breakdown = breakdown or brk
    resnorm = norm2(b - amat(x))
    with annotate("sync.result"):
        info = SolveInfo(converged=bool(resnorm / bnorm < tol * 1.01),
                         iters=step, resnorm=float(resnorm),
                         bnorm=float(bnorm), breakdown=breakdown)
    return x, info


@_solve_span
def cg(amat: Callable, prec: Callable, b: torch.Tensor, x0: torch.Tensor,
       tol: float = 1e-6, maxiter: int = 500):
    """Preconditioned conjugate gradients (SPD systems), with the
    eps²-scaled p·Ap breakdown guard and the r·z guard; z, r·z and p are
    updated even on the step that converges, as in JAX."""
    eps, tiny = _finfo(b)
    bnorm = norm2(b)
    r = b - amat(x0)
    z = prec(r)
    x, p, rz = x0, z, dot(r, z)
    resnorm = norm2(r)
    breakdown = torch.zeros((), dtype=torch.bool, device=b.device)
    step, done = 0, False
    while step < maxiter and not done:
        with annotate("krylov.iter"):
            ap = amat(p)
            pap = dot(p, ap)
            # breakdown: p·Ap structurally 0 (an indefinite operator) or
            # r·z annihilated; eps²-scale so f32 rounding at large n does
            # not fire
            brk = torch.abs(pap) \
                <= eps * eps * norm2(p) * norm2(ap) + 100 * tiny
            brk = brk | (torch.abs(rz) <= 100 * tiny)
            alpha = rz / guard_zero(pap)
            x = where(brk, x, x + alpha * p)
            r = where(brk, r, r - alpha * ap)
            resnorm = torch.where(brk, resnorm, norm2(r))
            conv = resnorm / bnorm < tol
            z = prec(r)
            rz_new = dot(r, z)
            p = z + (rz_new / guard_zero(rz)) * p
            rz = rz_new
            breakdown = breakdown | brk
            step += 1
            with annotate("sync.flag"):
                done = bool(conv | brk)          # one host sync per step
    with annotate("sync.result"):
        info = SolveInfo(converged=bool(resnorm / bnorm < tol), iters=step,
                         resnorm=float(resnorm), bnorm=float(bnorm),
                         breakdown=bool(breakdown))
    return x, info
