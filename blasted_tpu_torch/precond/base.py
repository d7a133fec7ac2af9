"""Preconditioner protocol (reference layer L4 root).

Port of ``blasted_tpu/precond/base.py`` (reference:
include/solverops_base.hpp:31-64): construction binds the operator to a
matrix view it does not own, :meth:`Preconditioner.compute` builds the
``state`` held on the object, :meth:`Preconditioner.apply` reads only
``(mat, state, r)``, and :meth:`Preconditioner.update_values` pushes new
values of the same sparsity through the padded, DIA and block-DIA forms.  The shard-state
hooks of the JAX class (``shard_setup``, ``compute_state_with``,
``patched_for_shards``: one template traced for every shard) have no
counterpart: the distributed solvers build one preconditioner per shard
(``parallel/dist.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import annotate

__all__ = ["SolveParams", "Preconditioner", "NoPreconditioner", "PrecInfo"]


class SolveParams(NamedTuple):
    """Relaxation stopping parameters (reference: solverops_base.hpp
    setApplyParams — rtol/abstol/dtol/maxits)."""

    rtol: float = 0.0
    atol: float = 0.0
    dtol: float = 0.0
    usetol: bool = False
    maxits: int = 1


class PrecInfo(NamedTuple):
    """Preconditioner-quality diagnostics
    (reference: include/preconditioner_diagnostics.hpp:14-57)."""

    prec_rem_initial_norm: float = 0.0
    prec_remainder_norm: float = 0.0
    lower_avg_diag_dom: float = 0.0
    lower_min_diag_dom: float = 0.0
    upper_avg_diag_dom: float = 0.0
    upper_min_diag_dom: float = 0.0


class Preconditioner:
    """Base class; concrete operators bind a device matrix and build state."""

    def __init__(self, mat):
        self.mat = mat
        self.state = None
        self.solveparams = SolveParams()

    def compute(self) -> PrecInfo:
        raise NotImplementedError

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self.apply_with(self.mat, self.state, r)

    def apply_with(self, mat, state, r: torch.Tensor) -> torch.Tensor:
        """Apply reading only ``(mat, state, r)`` plus static configuration."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement apply_with")

    def apply_relax(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def update_values(self, vals) -> None:
        """Push new numerical values through the operator, keeping every
        symbolic and cached structure — the PCSetUp-every-Newton-step
        workflow (reference: blasted_petsc.cpp:314-327).  ``vals`` is the
        flat value array of the padded form's host matrix (CSR ``(nnz,)``,
        BSR ``(nnzb, bs, bs)``) or the band data of DIA ``(k, n)`` and
        block-DIA (``(k, bs², nb)`` or ``(k, nb, bs, bs)``), a tensor or
        numpy array; call :meth:`compute` afterwards to re-factorize.  A
        ``precond.update`` span."""
        with annotate("precond.update"):
            if hasattr(self.mat, "with_new_vals"):
                self.mat = self.mat.with_new_vals(vals)
            elif hasattr(self.mat, "with_new_data"):
                self.mat = self.mat.with_new_data(vals)
            else:
                raise TypeError(
                    f"{type(self.mat).__name__} has no value-update form")

    def set_apply_params(self, params: SolveParams) -> None:
        """(reference: solverops_base.hpp setApplyParams)"""
        self.solveparams = params

    @property
    def device(self) -> torch.device:
        """The device the operator computes on: its matrix's."""
        return self.mat.device

    @property
    def block_size(self) -> int:
        """The matrix's block size: ``bs`` of a block form, 1 otherwise."""
        return getattr(self.mat, "bs", 1)

    def apply_flat(self, r: torch.Tensor) -> torch.Tensor:
        """Apply on a flat (n,) vector, the solvers' form; a block operator
        sees it as (nb, bs) block segments."""
        bs = self.block_size
        if bs == 1:
            return self.apply(r)
        return self.apply(r.reshape(-1, bs)).reshape(-1)


class NoPreconditioner(Preconditioner):
    """Identity (reference: solverops_base.hpp:80-106, 'none')."""

    def compute(self) -> PrecInfo:
        self.state = ()
        return PrecInfo()

    def apply_with(self, mat, state, r: torch.Tensor) -> torch.Tensor:
        return r

    def apply_relax(self, b, x):
        raise NotImplementedError("No relaxation for 'none' preconditioner")
