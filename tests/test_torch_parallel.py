"""The distributed layer of the PyTorch port (``blasted_tpu_torch.parallel``)
against the JAX package (``blasted_tpu.parallel``) on four CPU shards, in
float64: the partition field by field (exact), every SpMV form (1e-13),
the shard-local preconditioners (1e-12), the banded solvers' shard
operators against the JAX package's own operator on each shard's local
block (the block-Jacobi contract, 1e-12), the compressed block factor
against ``bdia_factor_sweeps_compressed`` called directly, the Krylov
methods on a sharded vector against the single-device run (1e-12), and the
mesh's CUDA default.

The JAX package's banded distributed operators take 6-30 s of CPU compile
per call here; they are compared whole in ``test_torch_dist_api.py`` (one
solve per route) and shard by shard against the single-device JAX
operators below."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasted_tpu import api as japi
from blasted_tpu import parallel as jpar
from blasted_tpu.config import AsyncSolverSettings as JSettings
from blasted_tpu.config import PrecType as JPrec
from blasted_tpu.factory import create_preconditioner as jax_create
from blasted_tpu.parallel import dist as jdist
from blasted_tpu.parallel.dist_dia import DistDiaSolver as JDistDia
from blasted_tpu.precond.bdia_ilu0 import (
    bdia_factor_sweeps_compressed as jax_compressed,
)
from blasted_tpu.sparse.bdia import bdia_from_bsr as jax_bdia_from_bsr
from blasted_tpu.sparse.bdia import bdia_pad_identity as jax_bdia_pad
from blasted_tpu.sparse.bsr import BSRMatrix as JBSR
from blasted_tpu.sparse.csr import CSRMatrix as JCSR
from blasted_tpu.sparse.dia import dia_from_csr as jax_dia_from_csr
from blasted_tpu.sparse.dia import dia_pad_identity as jax_dia_pad
from blasted_tpu_torch import solvers
from blasted_tpu_torch.api import solve
from blasted_tpu_torch.config import ApplyInit, AsyncSolverSettings, PrecType
from blasted_tpu_torch.ops.bdia import (
    cols_of,
    soa_dinv_mul,
    soa_mv_streams,
    stack_cols,
)
from blasted_tpu_torch.parallel import (
    DistributedSolver,
    LocalBlockPreconditioner,
    make_mesh,
    partition_bsr,
    partition_csr,
    shard_dist_csr,
    shard_vector,
)
from blasted_tpu_torch.parallel.dist_dia import (
    BANDED_TYPES,
    DistBlockDiaSolver,
    DistDiaSolver,
)
from blasted_tpu_torch.parallel.dryrun import (
    _block_tridiagonal,
    _random_bsr,
)
from blasted_tpu_torch.parallel.mesh import ShardedVector
from blasted_tpu_torch.apps import poisson3d_system
from blasted_tpu_torch.sparse import BSRMatrix, CSRMatrix
from blasted_tpu_torch.sparse.bdia import bdia_from_bsr, bdia_pad_identity
from blasted_tpu_torch.sparse.dia import dia_from_csr, dia_pad_identity

P = 4
ILU = dict(nbuildsweeps=2, napplysweeps=2)


def poisson(pts):
    return poisson3d_system(pts, dist="chebyshev")[0]


def block_band(nb, bs, offsets, seed):
    """A block-banded BSR matrix: 0.2·N(0,1) blocks on ``offsets``,
    3·bs on the diagonal blocks' diagonals."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(nb), len(offsets))
    cols = rows + np.tile(offsets, nb)
    keep = (cols >= 0) & (cols < nb)
    rows, cols = rows[keep], cols[keep]
    vals = 0.2 * rng.standard_normal((rows.shape[0], bs, bs))
    vals[rows == cols] += 3.0 * bs * np.eye(bs)
    rowptr = np.zeros(nb + 1, dtype=np.int32)
    np.add.at(rowptr[1:], rows, 1)
    return BSRMatrix.from_arrays(np.cumsum(rowptr), cols, vals, bs)


def random_csr(n, density, seed):
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    sp = sps.random(n, n, density=density, random_state=rng, format="csr")
    sp = (sp + sps.identity(n) * 4.0).tocsr()
    return CSRMatrix.from_scipy(sp)


# name → (host matrix, ghost plan taken)
SYSTEMS = {
    "csr-uneven": (poisson((5, 5, 7)), True),          # 45 rows
    "csr-even": (poisson((6, 6, 6)), True),            # 64 rows
    "csr-dense": (random_csr(40, 0.3, 3), False),
    "bsr-dense": (_random_bsr(np.random.default_rng(0), 32, 4, np.float64),
                  False),
    "bsr-uneven": (_block_tridiagonal(np.random.default_rng(1), 18, 3,
                                      np.float64), True),
}


def jax_matrix(A):
    if isinstance(A, BSRMatrix):
        return JBSR.from_arrays(A.rowptr, A.colind, A.vals, A.bs)
    return JCSR.from_arrays(A.rowptr, A.colind, A.vals)


def cpu_mesh():
    return make_mesh(devices=["cpu"] * P)


def partition(A):
    return partition_bsr(A, P) if isinstance(A, BSRMatrix) \
        else partition_csr(A, P)


# The JAX objects below are made once per module: JAX's partition pads each
# shard with eager operations (about 2 s a system on the CPU).

@functools.cache
def jax_mesh():
    return jpar.make_mesh(P)


@functools.cache
def jax_partition(name):
    Aj = jax_matrix(SYSTEMS[name][0])
    return jpar.partition_bsr(Aj, P) if isinstance(Aj, JBSR) \
        else jpar.partition_csr(Aj, P)


@functools.cache
def jax_placed(name):
    return jpar.shard_dist_csr(jax_mesh(), jax_partition(name))


def gathered(x) -> np.ndarray:
    return (x.gather() if isinstance(x, ShardedVector) else x).numpy()


# ------------------------------------------------------------ partition ----

# csr-even is left out: csr-dense is even too, and the ghost plan is the
# same code on an even row count as on csr-uneven's
@pytest.mark.parametrize("name", [n for n in SYSTEMS if n != "csr-even"])
def test_partition_matches_jax(name):
    """Every field, the send parts, deltas and row counts included; each
    placed local block equals the JAX stack's slice."""
    A, ghost = SYSTEMS[name]
    got, want = partition(A), jax_partition(name)
    assert (got.ghost_colind is not None) == ghost
    assert got.nshards == want.nshards == P
    assert got.nrows_orig == want.nrows_orig
    assert got.ghost_deltas == want.ghost_deltas
    np.testing.assert_array_equal(got.colind, np.asarray(want.colind))
    np.testing.assert_array_equal(got.vals_pad, np.asarray(want.vals_pad))
    if ghost:
        np.testing.assert_array_equal(got.ghost_colind,
                                      np.asarray(want.ghost_colind))
    else:
        assert want.ghost_colind is None
    assert len(got.send_parts) == len(want.send_parts)
    for a, b in zip(got.send_parts, want.send_parts):
        np.testing.assert_array_equal(a, np.asarray(b))
    placed = shard_dist_csr(cpu_mesh(), got)
    for d, loc in enumerate(placed.local):
        for f in dataclasses.fields(loc):
            a, b = getattr(loc, f.name), getattr(want.local, f.name)[d]
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"shard {d} {f.name}")


@pytest.mark.parametrize("block", [False, True])
def test_pad_identity_matches_jax(block):
    if block:
        B = SYSTEMS["bsr-uneven"][0]
        got = bdia_pad_identity(bdia_from_bsr(B, device="cpu"), 20)
        want = jax_bdia_pad(jax_bdia_from_bsr(jax_matrix(B)), 20)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        assert got.diag_mask_full is True
    else:
        A = SYSTEMS["csr-uneven"][0]
        got = dia_pad_identity(dia_from_csr(A, device="cpu"), 48)
        want = jax_dia_pad(jax_dia_from_csr(jax_matrix(A)), 48)
        np.testing.assert_array_equal(got.data.numpy(),
                                      np.stack(want.data))
    np.testing.assert_array_equal(got.mask.numpy(), np.stack(want.mask))


# ------------------------------------------------------------ the SpMVs ----

@pytest.mark.parametrize("name", ["csr-uneven", "csr-dense", "bsr-dense",
                                  "bsr-uneven"])
def test_general_spmv_matches_jax(name):
    """The ghost-exchange or the all-gather form, scalar or block."""
    A, ghost = SYSTEMS[name]
    ds = DistributedSolver(A, cpu_mesh(), AsyncSolverSettings(
        prec_type=PrecType.NONE))
    n = ds.dA.nrows_orig * ds.bs
    npad = (ds.dA.nrows if ds.bs == 1 else ds.dA.nbrows) * ds.bs
    x = np.zeros(npad)
    x[:n] = np.random.default_rng(5).standard_normal(n)
    y = gathered(ds.amat(shard_vector(ds.mesh, x)))
    jmesh, dj = jax_mesh(), jax_placed(name)
    xj = jpar.shard_vector(jmesh, x)
    block = "b" if ds.bs > 1 else ""
    if ghost:
        fn = getattr(jdist, f"dist_{block}spmv_ghost")
        want = fn(jmesh, dj.ghost_colind, dj.vals_pad, dj.send_parts,
                  dj.ghost_deltas, xj)
    else:
        want = getattr(jdist, f"dist_{block}spmv")(jmesh, dj.colind,
                                                  dj.vals_pad, xj)
    np.testing.assert_allclose(y, np.asarray(want), rtol=0, atol=1e-13)
    np.testing.assert_allclose(y[:n], (A.to_scipy() @ x[:n]), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("block", [False, True])
def test_banded_spmv_matches_jax(block):
    """The halo SpMV (K1/K5 twin interior pass + boundary corrections) on
    an uneven partition against scipy and, scalar, JAX's
    ``dist_dia_spmv``.  JAX's block ``amat`` compiles for ~30 s on the
    CPU: it is compared through the block-dia mode's solve without a
    preconditioner in ``test_torch_dist_api.py``."""
    none = AsyncSolverSettings(prec_type=PrecType.NONE)
    A = SYSTEMS["bsr-uneven" if block else "csr-uneven"][0]
    ds = (DistBlockDiaSolver if block else DistDiaSolver)(A, cpu_mesh(),
                                                          none)
    n = A.nrows
    x = np.zeros(ds.nl * P * (ds.bs if block else 1))
    x[:n] = np.random.default_rng(6).standard_normal(n)
    y = gathered(ds.amat(shard_vector(ds.mesh, x)))
    np.testing.assert_allclose(y[:n], A.to_scipy() @ x[:n], rtol=0,
                               atol=1e-13)
    np.testing.assert_array_equal(y[n:], x[n:])        # identity rows
    if not block:
        dj = JDistDia(jax_matrix(A), jax_mesh(),
                      JSettings(prec_type=JPrec.NONE))
        want = np.asarray(dj.amat(jpar.shard_vector(jax_mesh(), x)))
        np.testing.assert_allclose(y, want, rtol=0, atol=1e-13)


# ------------------------------------------- shard-local preconditioners ----

@pytest.mark.parametrize("name", ["csr-uneven", "bsr-uneven"])
@pytest.mark.parametrize("kind", ["ilu0", "seqilu0", "jacobi", "sgs"])
def test_local_block_preconditioner_matches_jax(kind, name):
    """``LocalBlockPreconditioner.apply`` (its reduced PrecInfo is compared
    through the ghost-csr and bsr-allgather modes in
    ``test_torch_dist_api.py``)."""
    A = SYSTEMS[name][0]
    settings = AsyncSolverSettings(prec_type=PrecType(kind), **ILU)
    mesh = cpu_mesh()
    dA = shard_dist_csr(mesh, partition(A))
    lp = LocalBlockPreconditioner(mesh, dA, settings).compute()
    lj = jpar.LocalBlockPreconditioner(jax_mesh(), jax_placed(name),
                                       JSettings(prec_type=JPrec(kind),
                                                 **ILU)).compute()
    n = dA.nbrows * A.bs if isinstance(A, BSRMatrix) else dA.nrows
    r = np.random.default_rng(7).standard_normal(n)
    z = gathered(lp.apply(shard_vector(mesh, r)))
    zj = np.asarray(lj.apply(jpar.shard_vector(jax_mesh(), r)))
    np.testing.assert_allclose(z, zj, rtol=0, atol=1e-12)


def _local_blocks(A):
    """Each shard's diagonal block of the identity-padded matrix, as the
    JAX package's host container (the partition equals JAX's, above)."""
    return [jax_matrix(m) for m in partition(A).local]


def _band(kind):
    if kind == "block":     # a fill pair off the main diagonal: plain route
        return block_band(22, 2, [-1, 0, 1, 2], seed=9)
    return SYSTEMS["csr-uneven"][0]


@pytest.mark.parametrize("kind", ["scalar", "block"])
@pytest.mark.parametrize("ptype", ["jacobi", "gs", "sgs", "ilu0"])
def test_banded_shard_operator_matches_jax_local(ptype, kind):
    """The banded solvers' apply on each shard equals the JAX package's
    single-device operator of the same type built on that shard's diagonal
    block — the block-Jacobi contract (JAX's
    ``test_dist_dia_local_ilu_matches_bjacobi_oracle``) — and the reduced
    ILU(0) PrecInfo equals the per-shard JAX diagnostics reduced (sum,
    mean, min).  The block band carries fill pairs off the main diagonal,
    so its factor is plain in both packages (ROADMAP.md C1)."""
    A = _band(kind)
    block = kind == "block"
    info = ptype == "ilu0"
    settings = AsyncSolverSettings(prec_type=PrecType(ptype),
                                   compute_precinfo=info, **ILU)
    cls = DistBlockDiaSolver if block else DistDiaSolver
    ds = cls(A, cpu_mesh(), settings)
    if block:
        assert not ds.compressed
    bs = ds.bs if block else 1
    m = ds.nl * bs
    r = np.random.default_rng(8).standard_normal(m * P)
    z = gathered(ds.prec_apply(shard_vector(ds.mesh, r)))
    jset = JSettings(prec_type=JPrec(ptype), compute_precinfo=info, **ILU)
    infos = []
    for s, loc in enumerate(_local_blocks(A)):
        D = jax_bdia_from_bsr(loc) if block else jax_dia_from_csr(loc)
        pj = jax_create(D, jset)
        infos.append(pj.compute())
        want = np.asarray(pj.apply_flat(jnp.asarray(r[s * m:(s + 1) * m])))
        np.testing.assert_allclose(z[s * m:(s + 1) * m], want, rtol=0,
                                   atol=1e-12, err_msg=f"shard {s}")
    if info:
        got = ds.precinfo()
        col = {f: np.array([float(getattr(i, f)) for i in infos])
               for f in got._fields}
        want = {"prec_remainder_norm": col["prec_remainder_norm"].sum(),
                "lower_avg_diag_dom": col["lower_avg_diag_dom"].mean(),
                "lower_min_diag_dom": col["lower_min_diag_dom"].min(),
                "upper_avg_diag_dom": col["upper_avg_diag_dom"].mean(),
                "upper_min_diag_dom": col["upper_min_diag_dom"].min()}
        for f, w in want.items():
            np.testing.assert_allclose(getattr(got, f), w, rtol=1e-12,
                                       atol=1e-12, err_msg=f)


def _inline_block_ilu_apply(ds, vl, di, rl, jacobi: bool):
    """The shard apply's ILU(0) branch as ``_apply_local`` wrote it before
    it called the shared sweep functions: torch products in the same
    order."""
    bs, offsets = ds.bs, ds.offsets
    ns = ds.settings.napplysweeps
    lower = [d for d, o in enumerate(offsets) if o < 0]
    upper = [d for d, o in enumerate(offsets) if o > 0]
    rc = cols_of(rl.view(-1, bs))
    zero = torch.zeros_like(rc)
    y = zero
    for _ in range(ns):
        y = rc - soa_mv_streams(vl, offsets, lower, y, bs)
    out = y if jacobi else zero
    for _ in range(ns):
        out = soa_dinv_mul(di, y - soa_mv_streams(vl, offsets, upper, out,
                                                  bs), bs)
    return stack_cols(out).reshape(-1)


@pytest.mark.parametrize("init", ["zero", "jacobi"])
@pytest.mark.parametrize("route", ["plain", "compressed"])
def test_block_ilu_apply_bitwise_unchanged(route, init):
    """The banded block solver's ILU(0) apply on every shard, now through
    ``ops/bdia.py``'s sweep functions (K7 on the card, its twin here),
    equals to the bit the inline torch loop it replaced, on the plain and
    the compressed factor, from a zero and a Jacobi start."""
    A = _band("block") if route == "plain" else SYSTEMS["bsr-uneven"][0]
    ds = DistBlockDiaSolver(A, cpu_mesh(), AsyncSolverSettings(
        prec_type=PrecType.ILU0, nbuildsweeps=3, napplysweeps=3,
        apply_init=ApplyInit.JACOBI if init == "jacobi" else ApplyInit.ZERO))
    assert ds.compressed is (route == "compressed")
    r = np.random.default_rng(12).standard_normal(ds.nl * ds.bs * P)
    rv = shard_vector(ds.mesh, r)
    got = ds.prec_apply(rv)
    for s, ((vl, di), rl) in enumerate(zip(ds._state, rv.parts)):
        want = _inline_block_ilu_apply(ds, vl, di, rl, init == "jacobi")
        assert torch.equal(got.parts[s], want), f"shard {s}"


def test_block_ilu0_solve_matches_jax():
    """``solve(mesh=...)`` with block ILU(0) on a band whose fill pair off
    the main diagonal sends both packages' DistBlockDiaSolver to the plain
    factor sweeps (ROADMAP.md C1), against the JAX package's solve on its
    CPU mesh: the same route and iterations, x within 1e-10.  The band is
    small (bs = 2, four diagonals) and the PrecInfo is left out: JAX's
    distributed block set-up and solve compile for about 30 s here, 60 s
    with the PrecInfo and 75 s at bs = 3 on five diagonals.  The block
    PrecInfo is held per shard to JAX's diagnostics in
    ``test_banded_shard_operator_matches_jax_local``."""
    B = _band("block")
    b = np.random.default_rng(11).standard_normal(B.nrows)
    opts = {"blasted_pc_type": "ilu0", "blasted_async_sweeps": "2,2",
            "rtol": 1e-8, "maxiter": 400}
    x, info, ctx = solve(B, b, opts, mesh=cpu_mesh())
    xj, ij, cj = japi.solve(jax_matrix(B), b, opts, mesh=jax_mesh())
    assert type(ctx.prec).__name__ == type(cj.prec).__name__ \
        == "DistBlockDiaSolver"
    assert not ctx.prec.compressed
    assert info.converged and bool(ij.converged)
    assert info.iters == int(ij.iters)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-10)


def test_compressed_block_route_matches_jax_function():
    """Where the band is eligible and every diagonal block is stored, the
    block factor takes the compressed sweeps on every device (K6 on the
    card, its twin here): each shard's factor equals the JAX package's
    ``bdia_factor_sweeps_compressed`` on that shard's masked band."""
    from blasted_tpu.precond.dia_ilu0 import dia_pairs as jax_pairs

    B = SYSTEMS["bsr-uneven"][0]
    ds = DistBlockDiaSolver(B, cpu_mesh(), AsyncSolverSettings(
        prec_type=PrecType.ILU0, nbuildsweeps=3, napplysweeps=2))
    assert ds.compressed
    offs, bs, nl = ds.offsets, ds.bs, ds.nl
    d0 = offs.index(0)
    r = np.arange(nl)
    for s, (dl, ml) in enumerate(zip(ds.data, ds.mask)):
        ml = np.stack([ml.numpy()[d] & (r + o >= 0) & (r + o < nl)
                       for d, o in enumerate(offs)])
        dl = np.where(ml[:, None, :], dl.numpy(), 0.0)
        mask = tuple(jnp.asarray(m) for m in ml)
        base = tuple(tuple(jnp.asarray(dl[d, c]) for c in range(bs * bs))
                     for d in range(len(offs)))
        want = jax_compressed(offs, jax_pairs(offs), d0, mask, base, base,
                              3, diag_mask_full=True)
        got = ds._state[s][0].numpy()
        for d in range(len(offs)):
            np.testing.assert_allclose(got[d], np.stack(want[d]), rtol=0,
                                       atol=1e-12, err_msg=f"shard {s}")


@pytest.mark.parametrize("ptype", [t for t in PrecType
                                   if t not in BANDED_TYPES])
def test_banded_solvers_refuse_other_types(ptype):
    """R3 (ROADMAP.md §3): only none, jacobi, gs, sgs and ilu0 are banded
    distributed types; the api falls back to the general route."""
    settings = AsyncSolverSettings(prec_type=ptype)
    with pytest.raises(TypeError, match="R3"):
        DistDiaSolver(SYSTEMS["csr-even"][0], cpu_mesh(), settings)
    with pytest.raises(TypeError, match="R3"):
        DistBlockDiaSolver(SYSTEMS["bsr-uneven"][0], cpu_mesh(), settings)


# ------------------------------------------------------- Krylov methods ----

@pytest.mark.parametrize("method", ["bicgstab", "cg", "gcr", "gmres",
                                    "richardson"])
def test_krylov_on_sharded_vectors_equals_single_device(method):
    """Jacobi is shard-local and global at once, so the 4-shard banded
    solve and the single-device solve are the same iteration up to the
    order of the dot sums: the same count, x within 1e-12."""
    A = SYSTEMS["csr-uneven"][0]
    b = np.random.default_rng(10).standard_normal(A.nrows)
    opts = {"blasted_pc_type": "jacobi", "ksp_type": method, "rtol": 1e-9,
            "maxiter": 2000, "restart": 7}
    x, info, ctx = solve(A, b, opts, mesh=cpu_mesh())
    assert type(ctx.prec).__name__ == "DistDiaSolver"
    x1, info1, _ = solve(A, b, opts, device="cpu")
    assert info.iters == info1.iters and info.converged == info1.converged
    np.testing.assert_allclose(x.numpy(), x1.numpy(), rtol=0, atol=1e-12)


def test_sharded_vector_arithmetic():
    mesh = cpu_mesh()
    a, b = np.arange(8.0), np.arange(8.0)[::-1].copy()
    va, vb = shard_vector(mesh, a), shard_vector(mesh, b)
    s = torch.tensor(2.0, dtype=torch.float64)
    np.testing.assert_array_equal(gathered(s * va - vb / s + 1.0),
                                  2 * a - b / 2 + 1)
    assert float(solvers.krylov.dot(va, vb)) == float(a @ b)
    flag = torch.tensor(False)
    np.testing.assert_array_equal(gathered(solvers.krylov.where(flag, va, vb)),
                                  b)


def test_make_mesh_needs_cuda_unless_asked():
    """The mesh defaults to the visible CUDA devices and never falls back
    to the CPU; a device may repeat."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(4, devices=["cuda:0"] * 4)
    mesh = make_mesh(2, devices=["cpu"] * 4, shape=(1, 2))
    assert mesh.size == 2 and mesh.axis_names == ("dcn", "ici")
    with pytest.raises(ValueError):
        make_mesh(devices=["cpu"] * 4, shape=(3,))
