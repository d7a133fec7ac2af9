"""The program's one-device block-banded route for a sequence of linear
systems: the block twin of ``dia_single.py``.

Set-up hands the host BSR matrix of the pool's first system to the
program's public entries, ``sparse.bdia.try_bdia_from_bsr`` →
``api.setup_local_preconditioner`` / ``api.compute_preconditioner``.  Each
system is then ``Preconditioner.update_values`` with the slot's block band
and ``api.compute_preconditioner`` (the PCSetUp of every Newton step), and
the configuration's Krylov method with the block-DIA SpMV (``bdia_spmv``)
and ``prec.apply_flat`` from x0 = 0.

The bands and right-hand sides of the pool are made on the device in
set-up, so a system's wall time holds only the program's calls.
"""

from __future__ import annotations

import torch

from blasted_tpu_torch import solvers
from blasted_tpu_torch.api import (compute_preconditioner,
                                   setup_local_preconditioner)
from blasted_tpu_torch.ops.bdia import bdia_spmv
from blasted_tpu_torch.sparse.bdia import try_bdia_from_bsr
from blasted_tpu_torch.sparse.bsr import BSRMatrix

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
        rowptr, colind, vals = inputs.host_bsr()
        self.bs = vals.shape[-1]
        B = try_bdia_from_bsr(BSRMatrix.from_arrays(rowptr, colind, vals,
                                                    self.bs),
                              device=self.device)
        del rowptr, colind, vals
        if B is None:
            raise ValueError("the configuration's matrix is not banded")
        self.ctx = setup_local_preconditioner(B, opts, device=self.device)
        compute_preconditioner(self.ctx)
        self.rhs = inputs.rhs(self.device, dtype)
        self.bands = inputs.bands(B.offsets, self.device, dtype)
        self.zero = torch.zeros_like(self.rhs[0])

    def _amat(self, x):
        return bdia_spmv(self.ctx.prec.mat, x.reshape(-1, self.bs)) \
            .reshape(-1)

    def step(self, i: int, spans):
        """The run's i-th system: (x, SolveInfo, slot)."""
        k = self.inputs.slot(i)
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
        """A copy of the factor the last step's applies read, as (bs², nb)
        slabs by block-column offset."""
        ilu = self.ctx.prec.state.ilu
        return {o: ilu[d].detach().clone()
                for d, o in enumerate(self.ctx.prec.mat.offsets)}

    def sync(self) -> None:
        for dev in self.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
