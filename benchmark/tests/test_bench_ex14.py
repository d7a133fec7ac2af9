"""The ex14 input maker and the plain reference against a dense Jacobian
and residual written loop by loop from ex14's FormJacobian/FormFunction."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from benchmark.problems import bratu3d as maker
from benchmark.reference import bratu3d as ref

LAM = 6.0


def dense_ex14(grid, lam, s):
    """(J, F) of ex14 at u = s·u0, by loops over the points."""
    mx, my, mz = grid
    hx, hy, hz = 1 / (mx - 1), 1 / (my - 1), 1 / (mz - 1)
    cx, cy, cz, sc = hy * hz / hx, hx * hz / hy, hx * hy / hz, \
        lam * hx * hy * hz
    n = mx * my * mz
    idx = lambda i, j, k: i + mx * (j + my * k)  # noqa: E731
    u = np.zeros(n)
    t1 = lam / (lam + 1)
    for k in range(mz):
        for j in range(my):
            for i in range(mx):
                if 0 < i < mx - 1 and 0 < j < my - 1 and 0 < k < mz - 1:
                    d = min(min(i, mx - i - 1) * hx, min(j, my - j - 1) * hy,
                            min(k, mz - k - 1) * hz)
                    u[idx(i, j, k)] = s * t1 * np.sqrt(d)
    J = np.zeros((n, n))
    F = np.zeros(n)
    for k in range(mz):
        for j in range(my):
            for i in range(mx):
                r = idx(i, j, k)
                if not (0 < i < mx - 1 and 0 < j < my - 1 and 0 < k < mz - 1):
                    J[r, r] = 1.0
                    F[r] = u[r]
                    continue
                J[r, idx(i, j, k - 1)] = J[r, idx(i, j, k + 1)] = -cz
                J[r, idx(i, j - 1, k)] = J[r, idx(i, j + 1, k)] = -cy
                J[r, idx(i - 1, j, k)] = J[r, idx(i + 1, j, k)] = -cx
                J[r, r] = 2 * (cx + cy + cz) - sc * np.exp(u[r])
                F[r] = (cx * (2 * u[r] - u[idx(i - 1, j, k)]
                              - u[idx(i + 1, j, k)])
                        + cy * (2 * u[r] - u[idx(i, j - 1, k)]
                                - u[idx(i, j + 1, k)])
                        + cz * (2 * u[r] - u[idx(i, j, k - 1)]
                                - u[idx(i, j, k + 1)])
                        - sc * np.exp(u[r]))
    return J, F


GRIDS = [(5, 5, 5), (5, 6, 7)]


def _u(grid, s):
    """The reference's two iterates, both s·u0."""
    u = s * ref.initial_guess(grid, LAM, "cpu")
    return u, u


@pytest.mark.parametrize("grid", GRIDS)
def test_host_csr_is_ex14_jacobian(grid):
    J, _ = dense_ex14(grid, LAM, 1.1)
    rowptr, colind, vals, diagind = maker.host_csr(
        grid, LAM, 1.1 * maker.guess(grid, LAM, "cpu"), np.float64)
    n = J.shape[0]
    A = sps.csr_matrix((vals, colind, rowptr), shape=(n, n)).toarray()
    np.testing.assert_allclose(A, J, rtol=1e-14, atol=1e-16)
    assert (colind[diagind] == np.arange(n)).all()
    for r in range(n):                       # sorted columns in each row
        row = colind[rowptr[r]:rowptr[r + 1]]
        assert (np.diff(row) > 0).all()
    # the pattern as PETSc stores it: 7 entries inside, 1 on the boundary
    assert set(np.diff(rowptr)) == {1, 7}
    assert np.count_nonzero(A) == vals.shape[0]


@pytest.mark.parametrize("grid", GRIDS)
def test_band_and_rhs_match_dense(grid):
    J, F = dense_ex14(grid, LAM, 0.8)
    offs = maker.offsets(grid)
    u = 0.8 * maker.guess(grid, LAM, "cpu")
    band = maker.band_values(grid, LAM, u, offs, "cpu",
                             torch.float64).numpy()
    n = J.shape[0]
    for d, o in enumerate(offs):
        for i in range(n):
            want = J[i, i + o] if 0 <= i + o < n else 0.0
            assert band[d, i] == pytest.approx(want, rel=1e-14, abs=1e-300)
    b = maker.rhs(grid, LAM, u, "cpu", torch.float64).numpy()
    np.testing.assert_allclose(b, -F, rtol=1e-12, atol=1e-18)


@pytest.mark.parametrize("grid", GRIDS)
def test_reference_system_matches_dense(grid):
    J, F = dense_ex14(grid, LAM, 1.3)
    system = ref.System(grid, LAM, *_u(grid, 1.3), torch.float64, "cpu")
    x = torch.randn(J.shape[0], dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(system.matvec(x).numpy(), J @ x.numpy(),
                               rtol=1e-13, atol=1e-16)
    np.testing.assert_allclose(system.b.reshape(-1).numpy(), -F,
                               rtol=1e-12, atol=1e-18)


def test_reference_solves_like_a_dense_solve():
    grid = (7, 7, 7)
    J, F = dense_ex14(grid, LAM, 1.0)
    system = ref.System(grid, LAM, *_u(grid, 1.0), torch.float64, "cpu")
    x, it = ref.bicgstab(system, torch.float64, 8, 4, 1e-12, 500)
    exact = np.linalg.solve(J, -F)
    np.testing.assert_allclose(x.numpy(), exact, rtol=1e-9,
                               atol=1e-11 * np.abs(exact).max())
    assert ref.relres(system, x) < 1e-11 and 0 < it < 500


def dense_ilu0(A):
    """ILU(0) of a dense matrix on its own pattern, row by row (IKJ)."""
    n = A.shape[0]
    LU = A.copy()
    pat = A != 0
    for i in range(1, n):
        for k in range(i):
            if not pat[i, k]:
                continue
            LU[i, k] /= LU[k, k]
            for j in range(k + 1, n):
                if pat[i, j]:
                    LU[i, j] -= LU[i, k] * LU[k, j]
    return LU


def test_reference_sweeps_reach_exact_ilu0():
    """The Chow–Patel fixed point is ILU(0): enough sweeps reach it."""
    grid = (5, 6, 5)
    J, _ = dense_ex14(grid, LAM, 1.0)
    LU = dense_ilu0(J)
    system = ref.System(grid, LAM, *_u(grid, 1.0), torch.float64, "cpu")
    f = ref.factor_sweeps(system, 60)
    offs = maker.offsets(grid)
    n = J.shape[0]
    for d, o in zip(ref.DIRECTIONS, offs):
        got = f[d].reshape(-1).numpy()
        want = np.array([LU[i, i + o] if 0 <= i + o < n and J[i, i + o] != 0
                         else 0.0 for i in range(n)])
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_factor_gap_and_relres_see_a_change():
    grid = (6, 6, 6)
    system = ref.System(grid, LAM, *_u(grid, 1.0), torch.float32, "cpu")
    f = ref.factor_sweeps(system, 8)
    assert ref.factor_gap(system, f, 8) == 0.0
    f2 = dict(f)
    # the gap is scaled by the interior rows, not the boundary's 1
    f2["c"] = torch.where(system.interior, f["c"] * (1 + 1e-3), f["c"])
    assert ref.factor_gap(system, f2, 8) == pytest.approx(1e-3, rel=1e-6)
    f2["c"] = f["c"] + 1e-3 * f["c"][system.interior].abs().max()
    assert ref.factor_gap(system, f2, 8) == pytest.approx(1e-3, rel=1e-6)
    x, _ = ref.bicgstab(system, torch.float64, 8, 4, 1e-12, 500)
    assert ref.relres(system, x) < 1e-11
    assert ref.relres(system, torch.zeros_like(x)) == 1.0
