"""The program's one-device banded route for a sequence of linear systems.

Set-up hands the host CSR matrix of the pool's first system to the
program's public entries, ``sparse.dia.try_dia_from_csr`` →
``api.setup_local_preconditioner`` / ``api.compute_preconditioner``.  Each
system is then, where every system brings its own matrix,
``Preconditioner.update_values`` with the slot's band and
``api.compute_preconditioner`` (the PCSetUp of every Newton step), and
the configuration's Krylov method with the DIA SpMV and
``prec.apply_flat`` from x0 = 0.

The bands and right-hand sides of the pool are made on the device in
set-up, so a system's wall time holds only the program's calls.
"""

from __future__ import annotations

import torch

from blasted_tpu_torch import solvers
from blasted_tpu_torch.api import (compute_preconditioner,
                                   setup_local_preconditioner)
from blasted_tpu_torch.ops.spmv import spmv
from blasted_tpu_torch.sparse.csr import CSRMatrix
from blasted_tpu_torch.sparse.dia import try_dia_from_csr

__all__ = ["Route"]


class Route:
    """See the module docstring; ``inputs`` is the problem's pool."""

    def __init__(self, inputs, cfg: dict, devices):
        self.device = torch.device(devices[0])
        self.devices = (self.device,)
        self.inputs = inputs
        opts = cfg["options"]
        self.tol, self.maxiter = float(opts["rtol"]), int(opts["maxiter"])
        self.method = getattr(solvers, opts["ksp_type"])
        dtype = getattr(torch, cfg["dtype"])
        rowptr, colind, vals, diagind = inputs.host_csr()
        D = try_dia_from_csr(CSRMatrix(rowptr=rowptr, colind=colind,
                                       vals=vals, diagind=diagind),
                             device=self.device)
        del rowptr, colind, vals, diagind
        if D is None:
            raise ValueError("the configuration's matrix is not banded")
        self.ctx = setup_local_preconditioner(D, opts, device=self.device)
        compute_preconditioner(self.ctx)
        self.rhs = inputs.rhs(self.device, dtype)
        self.bands = inputs.bands(D.offsets, self.device, dtype)
        self.zero = torch.zeros_like(self.rhs[0])

    def _amat(self, x):
        return spmv(self.ctx.prec.mat, x)

    def step(self, i: int, spans):
        """The run's i-th system: (x, SolveInfo, slot)."""
        k = self.inputs.slot(i)
        if self.bands is not None:
            with spans("update"):
                self.ctx.prec.update_values(self.bands[k])
            with spans("factor"):
                compute_preconditioner(self.ctx)
        with spans("krylov"):
            x, info = self.method(self._amat, self.ctx.prec.apply_flat,
                                  self.rhs[k], self.zero, tol=self.tol,
                                  maxiter=self.maxiter)
        return x, info, k

    def factor(self) -> dict:
        """A copy of the factor the last step's applies read (this step's
        re-factor, or set-up's where the matrix is lagged), as (n,) rows by
        column offset."""
        ilu = self.ctx.prec.state.ilu
        return {o: ilu[d].detach().clone()
                for d, o in enumerate(self.ctx.prec.mat.offsets)}

    def sync(self) -> None:
        for dev in self.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
