"""High-level solver API — the ``-blasted_*`` options namespace and the
single-device solve.

Port of ``blasted_tpu/api.py`` (reference: the PETSc-plugin layer,
include/blasted_petsc.h:31-111, src/blasted_petsc.cpp:136-208 option
parsing, :403-576 PCShell callbacks):

- :class:`BlastedOptions` parses the same option names as the JAX package,
  from a dict or an argv-style list;
- :class:`SolverContext` holds the preconditioner and its timers;
- :func:`setup_local_preconditioner` / :func:`compute_preconditioner` /
  :func:`apply_local` are the PCShell callback triad, :func:`relax_local`
  the relaxation callback;
- :func:`solve` solves in one call: host CSR or BSR matrix + RHS → x
  on ``device``, on the JAX package's routes (banded → DIA or block-DIA;
  not banded → RCM banding, else padded CSR/BSR; ``prefer_dia=False`` →
  padded CSR/BSR); with ``mesh=`` (``parallel.make_mesh``) it solves over
  the mesh's shards on the JAX package's distributed routes (AMG, then
  banded DIA or block-DIA, then general).

- :func:`solve_refined` is the mixed-precision refinement: the device
  solves in float32 (``inner_dtype``), the host residual is float64.

Every entry point that creates tensors runs on the card (``"cuda"``) unless
the caller asks for another device; without a card that default raises.
Every ``ksp_type`` (richardson, cg, gcr, gmres, bicgstab), every
``pc_type`` of the JAX factory and ``-blasted_apply_dtype`` (the DIA and
block-DIA ILU(0) factors stored in bfloat16 or float32) are ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .config import ApplyInit, AsyncSolverSettings, FactInit, PrecType
from .factory import (
    DEVICE_FORMS,
    create_preconditioner,
    rcm_banded_device_matrix,
    to_device_matrix,
)
from .ops.spmv import bspmv, spmv
from .precond.base import SolveParams
from .precond.reordering import FORWARD
from .solvers import SolveInfo, bicgstab, cg, gcr, gmres, richardson
from .sparse.bdia import BlockDiaMatrix
from .sparse.bsr import BSRMatrix
from .sparse.csr import CSRMatrix
from .sparse.dia import DiaMatrix, try_dia_from_csr
from .utils.profiling import annotate, count
from .utils.timing import PrecTimers, synchronize

__all__ = ["BlastedOptions", "SolverContext", "setup_local_preconditioner",
           "compute_preconditioner", "apply_local", "relax_local", "solve",
           "solve_refined"]


@dataclass
class BlastedOptions:
    """The ``-blasted_*`` option namespace (reference: doc/user-doc.md:6-31,
    parsing in blasted_petsc.cpp:136-208)."""

    pc_type: str = "jacobi"             # -blasted_pc_type
    async_sweeps: tuple = (1, 1)        # -blasted_async_sweeps b,a (−1 ⇒ exact)
    use_symmetric_scaling: bool = False  # -blasted_use_symmetric_scaling
    fact_init_type: str = "init_original"   # -blasted_async_fact_init_type
    apply_init_type: str = "init_zero"      # -blasted_async_apply_init_type
    compute_precinfo: bool = False      # -blasted_compute_preconditioner_info
    thread_chunk_size: int = 0          # -blasted_thread_chunk_size
    apply_dtype: str | None = None      # -blasted_apply_dtype bfloat16|float32
    # solver-side options (the reference leaves these to PETSc's -ksp_*)
    ksp_type: str = "bicgstab"
    rtol: float = 1e-8
    maxiter: int = 1000
    restart: int = 30
    prefer_dia: bool = True
    # AMG namespace (-blasted_amg_*), mapped onto
    # precond.multigrid.AMGSettings
    amg_group: int = 4
    amg_grid_shape: tuple | None = None
    amg_cycle: str = "v"
    amg_npre: int = 1
    amg_npost: int = 1
    amg_max_levels: int = 12
    amg_coarse_size: int = 200
    amg_smoother_kind: str = "factory"
    amg_sub_pc_type: str = "sgs"
    amg_smooth_prolongator: bool = False
    amg_jacobi_omega: float = 1.4
    amg_cheby_degree: int = 2

    @staticmethod
    def from_dict(opts: dict) -> "BlastedOptions":
        o = BlastedOptions()
        for key, val in opts.items():
            k = key.lstrip("-")
            if k.startswith("blasted_"):
                k = k[len("blasted_"):]
            if k in ("async_sweeps", "amg_grid_shape"):
                if isinstance(val, str):
                    val = tuple(int(s) for s in val.split(","))
                setattr(o, k, tuple(val))
            elif k == "async_fact_init_type":
                o.fact_init_type = str(val)
            elif k == "async_apply_init_type":
                o.apply_init_type = str(val)
            elif k == "compute_preconditioner_info":
                o.compute_precinfo = _truthy(val)
            elif k == "use_symmetric_scaling":
                o.use_symmetric_scaling = _truthy(val)
            elif hasattr(o, k):
                cur = getattr(o, k)
                if isinstance(cur, bool):
                    setattr(o, k, _truthy(val))
                elif isinstance(cur, int):
                    setattr(o, k, int(val))
                elif isinstance(cur, float):
                    setattr(o, k, float(val))
                else:
                    setattr(o, k, val)
            else:
                raise ValueError(f"Unknown option: {key}")
        return o

    @staticmethod
    def from_argv(argv) -> "BlastedOptions":
        """Parse '-blasted_pc_type ilu0 -blasted_async_sweeps 4,3 ...' lists
        (the PETSc options-database style)."""
        d = {}
        i = 0
        while i < len(argv):
            key = argv[i]
            if not key.startswith("-"):
                raise ValueError(f"Expected -option, got {key!r}")
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                d[key] = argv[i + 1]
                i += 2
            else:
                d[key] = True
                i += 1
        return BlastedOptions.from_dict(d)

    def settings(self) -> AsyncSolverSettings:
        return AsyncSolverSettings(
            prec_type=PrecType(self.pc_type),
            nbuildsweeps=int(self.async_sweeps[0]),
            napplysweeps=int(self.async_sweeps[1]),
            use_symmetric_scaling=self.use_symmetric_scaling,
            fact_init=FactInit(self.fact_init_type),
            apply_init=ApplyInit(self.apply_init_type),
            compute_precinfo=self.compute_precinfo,
            thread_chunk_size=self.thread_chunk_size,
            apply_dtype=_parse_dtype(self.apply_dtype),
            amg=self.amg_settings() if self.pc_type == "amg" else None,
        )

    def amg_settings(self):
        """AMGSettings from the ``-blasted_amg_*`` namespace; the factory
        smoother takes the standalone options with ``amg_sub_pc_type`` as
        its ``pc_type`` (the reference walker hands each MG level's smoother
        the same ``-blasted_*`` options, blasted_petsc.cpp:610-630), its
        apply sweeps floored at 2 as in the JAX package."""
        from .precond.multigrid import AMGSettings

        smoother = AsyncSolverSettings(
            prec_type=PrecType(self.amg_sub_pc_type),
            nbuildsweeps=int(self.async_sweeps[0]),
            napplysweeps=max(2, int(self.async_sweeps[1])),
            use_symmetric_scaling=self.use_symmetric_scaling,
            fact_init=FactInit(self.fact_init_type),
            apply_init=ApplyInit(self.apply_init_type),
        )
        return AMGSettings(
            group=self.amg_group, grid_shape=self.amg_grid_shape,
            max_levels=self.amg_max_levels, coarse_size=self.amg_coarse_size,
            cycle=self.amg_cycle, npre=self.amg_npre, npost=self.amg_npost,
            smooth_prolongator=self.amg_smooth_prolongator,
            smoother_kind=self.amg_smoother_kind,
            jacobi_omega=self.amg_jacobi_omega,
            cheby_degree=self.amg_cheby_degree, smoother=smoother,
        )


def _truthy(v) -> bool:
    return v in (True, 1, "1", "true", "True", "yes")


def _parse_dtype(name):
    if name is None or not isinstance(name, str):
        return name
    return getattr(torch, name)  # "bfloat16" | "float32" | "float64"


def _as_options(options) -> BlastedOptions:
    if options is None:
        return BlastedOptions()
    if isinstance(options, dict):
        return BlastedOptions.from_dict(options)
    if isinstance(options, (list, tuple)):
        return BlastedOptions.from_argv(options)
    return options


@dataclass
class SolverContext:
    """``Blasted_data`` equivalent (reference: blasted_petsc.h:31-85)."""

    prec: object = None
    options: BlastedOptions = field(default_factory=BlastedOptions)
    timers: PrecTimers = field(default_factory=PrecTimers)
    first_setup_done: bool = False
    infolist: list = field(default_factory=list)   # PrecInfoList analogue
    passes: int = 0         # inner solves of the last solve_refined


def setup_local_preconditioner(A, options=None, *, device=None) -> SolverContext:
    """(reference: setup_localpreconditioner_blasted, blasted_petsc.cpp:663-721)

    ``A`` is a device matrix (DIA, block-DIA, padded CSR or BSR) already
    on its device, or a host CSR/BSR matrix that is put on ``device`` (the
    card, ``"cuda"``, unless given).  ``amg`` takes the host matrix and
    builds its hierarchy on ``device``.  Counts its calls and host seconds
    in ``utils.profiling.counters`` (``setup.precond``,
    ``setup.precond_s``; :func:`compute_preconditioner` adds the first
    factor's)."""
    t0 = time.perf_counter()
    try:
        options = _as_options(options)
        settings = options.settings()
        if isinstance(A, DEVICE_FORMS):
            if device is not None and torch.device(device) != A.device:
                raise ValueError(f"matrix is on {A.device}, not {device}")
            D = A
        elif options.pc_type == "amg":
            D = A       # the hierarchy is built from the host container
        else:
            D = to_device_matrix(A, device="cuda" if device is None
                                 else device, prefer_dia=options.prefer_dia)
        ctx = SolverContext(options=options)
        ctx.prec = create_preconditioner(
            D, settings, device="cuda" if device is None else device)
        ctx.first_setup_done = True
        return ctx
    finally:
        count("setup.precond")
        count("setup.precond_s", time.perf_counter() - t0)


def compute_preconditioner(ctx: SolverContext):
    """(reference: compute_preconditioner_blasted, blasted_petsc.cpp:403-430)
    A ``precond.compute`` span.  A context's first call ends its set-up:
    its host seconds, the card synchronised at the end, are added to
    ``utils.profiling.counters["setup.precond_s"]``."""
    first = ctx.timers.factor_calls == 0
    t0 = time.perf_counter()
    with annotate("precond.compute"), \
            ctx.timers.time_factor(ctx.prec.device):
        info = ctx.prec.compute()
    if first:
        count("setup.precond_s", time.perf_counter() - t0)
    if ctx.options.compute_precinfo:
        ctx.infolist.append(info)
    return info


def apply_local(ctx: SolverContext, r) -> torch.Tensor:
    """(reference: apply_local_blasted, blasted_petsc.cpp:474-517)"""
    device = ctx.prec.device
    with ctx.timers.time_apply(device):
        return ctx.prec.apply_flat(torch.as_tensor(r, device=device))


def relax_local(ctx: SolverContext, b, x, maxits: int = 1) -> torch.Tensor:
    """(reference: relax_local_blasted, blasted_petsc.cpp:519-576 — used
    under Richardson with scale 1.0 there; same contract here)."""
    device = ctx.prec.device
    ctx.prec.set_apply_params(SolveParams(maxits=maxits))
    with ctx.timers.time_apply(device):
        return ctx.prec.apply_relax(torch.as_tensor(b, device=device),
                                    torch.as_tensor(x, device=device))


def _as_vector(v, device, dtype) -> torch.Tensor:
    t = v.to(device) if isinstance(v, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(v)).to(device)
    if t.dtype != dtype:
        raise TypeError(f"vector is {t.dtype}, the matrix is {dtype}")
    return t


_SOLVERS = {"richardson": richardson, "bicgstab": bicgstab, "gcr": gcr,
            "gmres": gmres, "cg": cg}


def solve(A, b, options=None, *, device="cuda", mesh=None, x0=None):
    """One-call solve: host CSR or BSR matrix + flat RHS → (x, SolveInfo,
    ctx), the solve running on ``device`` (the card unless ``"cpu"`` is
    asked for).

    With ``mesh`` (``parallel.make_mesh``) the rows are sharded over the
    mesh's devices, which replace ``device``, and the preconditioner is
    shard-local — the reference under ``-pc_type bjacobi -sub_pc_type
    shell`` (SURVEY.md §2.5 P8); x comes back on the mesh's first
    device."""
    options = _as_options(options)
    if mesh is not None:
        return _mesh_solve(A, b, options, mesh, x0)
    ctx, run = _single_chip_driver(A, options, torch.device(device))
    x, info = run(b, x0)
    return x, info, ctx


def _restart_kw(options: BlastedOptions) -> dict:
    """The Krylov method's restart keyword: GCR and GMRES take one."""
    return {"nrestart": options.restart} \
        if options.ksp_type in ("gcr", "gmres") else {}


def _mesh_solve(A, b, options: BlastedOptions, mesh, x0):
    """The distributed routes of JAX ``api.solve`` (:273-317), in order:
    AMG; the banded DIA / block-DIA solvers, which give way to the general
    solver by raising ``ValueError`` or ``TypeError``; the general one."""
    from .parallel import DistMGSolver, DistributedSolver
    from .parallel.dist_dia import DistBlockDiaSolver, DistDiaSolver

    kw = _restart_kw(options)
    settings = options.settings()
    ctx = SolverContext(options=options)
    ds = None
    with ctx.timers.time_factor(mesh.devices):   # set-up and shard factors
        if options.pc_type == "amg":
            ds = DistMGSolver(A, mesh, options.amg_settings())
        if ds is None and options.prefer_dia:
            try:
                if isinstance(A, CSRMatrix):
                    D = try_dia_from_csr(A, device="cpu")
                    if D is not None:
                        ds = DistDiaSolver(D, mesh, settings)
                elif isinstance(A, BSRMatrix):
                    ds = DistBlockDiaSolver(A, mesh, settings)
            except (ValueError, TypeError):
                ds = None   # band too wide, or not a banded type: general
        if ds is None:
            ds = DistributedSolver(A, mesh, settings)
    ctx.prec = ds
    ctx.first_setup_done = True
    if options.compute_precinfo:
        info = getattr(ds, "precinfo", lambda: None)()
        if info is not None:
            ctx.infolist.append(info)
    mesh.synchronize()
    t0 = time.perf_counter()
    x, info = ds.solve(b, x0=x0, method=options.ksp_type, tol=options.rtol,
                       maxiter=options.maxiter, **kw)
    mesh.synchronize()
    ctx.timers.apply_walltime += time.perf_counter() - t0
    return x, info, ctx


def _single_chip_driver(A, options: BlastedOptions, device: torch.device):
    """Build the single-device solve once: device matrix (with the RCM
    banding decision), preconditioner context (factored), and a
    ``run(b, x0)`` callable that solves with it."""
    if options.ksp_type not in _SOLVERS:
        raise ValueError(f"unknown ksp_type {options.ksp_type!r}")
    solver = _SOLVERS[options.ksp_type]
    kw = _restart_kw(options)
    options.settings()          # reject bad options before any work
    D = to_device_matrix(A, device=device, prefer_dia=options.prefer_dia)
    reord = None
    if options.prefer_dia and not isinstance(D, (DiaMatrix, BlockDiaMatrix)):
        # unstructured: try banding by RCM, as the JAX package does
        D2, reord = rcm_banded_device_matrix(A, device=device)
        if D2 is not None:
            D = D2
    if options.pc_type == "amg":
        # the hierarchy comes from the host matrix, permuted as D is
        A_host = A if reord is None else reord.apply_to_matrix(A, FORWARD)
        ctx = setup_local_preconditioner(A_host, options, device=device)
    else:
        ctx = setup_local_preconditioner(D, options)
    compute_preconditioner(ctx)

    bs = getattr(D, "bs", 1)
    if bs > 1:
        def amat(x):
            return bspmv(D, x.reshape(-1, bs)).reshape(-1)
    else:
        def amat(x):
            return spmv(D, x)

    def run(b, x0=None, tol=None):
        bvec = _as_vector(b, D.device, D.dtype)
        x0v = torch.zeros_like(bvec) if x0 is None \
            else _as_vector(x0, D.device, D.dtype)
        if reord is not None:
            # solve the RCM-permuted system: b̃ = P_r b; x = P_cᵀ x̃
            rp = torch.from_numpy(reord.rp).to(D.device)
            bvec = bvec.reshape(-1, bs)[rp].reshape(-1)
            x0v = x0v.reshape(-1, bs)[rp].reshape(-1)
        synchronize(D.device)
        t0 = time.perf_counter()
        x, info = solver(amat, ctx.prec.apply_flat, bvec, x0v,
                         tol=options.rtol if tol is None else tol,
                         maxiter=options.maxiter, **kw)
        synchronize(D.device)
        ctx.timers.apply_walltime += time.perf_counter() - t0
        if reord is not None:
            cp = torch.from_numpy(reord.cp).to(D.device)
            xb = x.reshape(-1, bs)
            x = torch.zeros_like(xb).index_copy_(0, cp, xb).reshape(-1)
        return x, info

    return ctx, run


def solve_refined(A, b, options=None, nrefine: int = 2,
                  inner_dtype=torch.float32, inner_rtol: float = 5e-7, *,
                  device="cuda"):
    """Mixed-precision iterative refinement (JAX ``api.solve_refined``):
    the device works in ``inner_dtype`` (the host matrix cast to it); the
    outer loop computes the true residual in float64 on the host (scipy)
    and solves for the correction, normalised to an O(1) right-hand side,
    with the preconditioner of the first pass, at most ``nrefine + 1``
    passes.  Returns ``(x, SolveInfo, ctx)``: x a float64 numpy array,
    ``iters`` summed over the passes, their number in ``ctx.passes``."""
    options = _as_options(options)
    np_inner = torch.empty((), dtype=inner_dtype).numpy().dtype
    sp = A.to_scipy().astype(np.float64)        # the float64 operator
    b64 = np.asarray(b, dtype=np.float64)
    bnorm = float(np.linalg.norm(b64))
    ctx, run = _single_chip_driver(A.astype(np_inner), options,
                                   torch.device(device))
    itol = max(float(options.rtol), float(inner_rtol))

    x = np.zeros_like(b64)
    total = 0
    breakdown = False
    for _ in range(nrefine + 1):
        r = b64 - sp @ x
        resnorm = float(np.linalg.norm(r))
        if resnorm <= options.rtol * bnorm:
            break
        dx, info = run((r / resnorm).astype(np_inner), tol=itol)
        ctx.passes += 1
        x = x + resnorm * dx.cpu().numpy().astype(np.float64)
        total += int(info.iters)
        breakdown = breakdown or bool(info.breakdown)
    resnorm = float(np.linalg.norm(b64 - sp @ x))
    return x, SolveInfo(converged=resnorm <= options.rtol * bnorm,
                        iters=total, resnorm=resnorm, bnorm=bnorm,
                        breakdown=breakdown), ctx
