"""The PyTorch port's apps and utils against the JAX package, on the CPU:
the ``testsolve`` and ``compare_solvers`` CLIs (``--device cpu``), the
sweep-scaling harness ``perftest`` on a 10³ grid, the async-ILU
convergence histories, ``total_times``, ``trace``/``annotate`` into
``tmp_path``, and the BLAS-1 helpers ``maxnorm`` and ``axpbypcz``."""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasted_tpu import api as japi
from blasted_tpu.apps import compare_solvers as jax_compare
from blasted_tpu.apps import poisson3d_system as jax_poisson3d_system
from blasted_tpu.apps import testsolve as jax_testsolve
from blasted_tpu.ops import blas1 as jblas1
from blasted_tpu.sparse.csr import CSRMatrix as JaxCSRMatrix
from blasted_tpu.utils import convergence as jconvergence
from blasted_tpu.utils import timing as jtiming
from blasted_tpu_torch import api
from blasted_tpu_torch.apps import compare_solvers, poisson3d_system, testsolve
from blasted_tpu_torch.ops import blas1
from blasted_tpu_torch.sparse import (
    COOMatrix,
    CSRMatrix,
    write_matrix_market,
    write_petsc_matrix,
    write_petsc_vector,
)
from blasted_tpu_torch.utils import convergence, perftest, profiling, timing
from helpers import random_csr


def _write_system(d, npts=(8, 8, 8)):
    """The uniform-grid Poisson system as .mtx files (A, b, x = A⁻¹b)."""
    A, b, _ = poisson3d_system(npts, "uniform")
    sp = A.to_scipy().tocoo()
    write_matrix_market(str(d / "A.mtx"), COOMatrix(
        A.nrows, A.nrows, sp.row.astype(np.int32), sp.col.astype(np.int32),
        sp.data))
    import scipy.sparse.linalg as spla
    x = spla.spsolve(A.to_scipy().tocsc(), b)
    for name, v in (("b.mtx", b), ("x.mtx", x)):
        (d / name).write_text("%%MatrixMarket matrix array real general\n"
                              f"{v.size} 1\n"
                              + "".join(f"{float(t)!r}\n" for t in v))
    return A, b, x


def _iters(text: str) -> int:
    return int(re.search(r"iters=(\d+)", text).group(1))


@pytest.mark.parametrize("args", [
    ["--prec", "ilu0", "--build-sweeps", "2", "--apply-sweeps", "3"],
    ["--prec", "sgs", "--solver", "gmres"],
    # padded storage with the DIA case's sweeps: after one factor sweep
    # BiCGSTAB amplifies the rounding of a summation order into the count
    # (C7; scripts/padded_iters_witness.py)
    ["--prec", "ilu0", "--no-dia", "--build-sweeps", "2", "--apply-sweeps",
     "3"],
])
def test_testsolve_main_matches_jax(tmp_path, capsys, args):
    """``testsolve`` on .mtx files with a reference solution: exit 0, the
    JAX app's iteration count, and the port's storage printed."""
    _write_system(tmp_path)
    common = ["--matrix", str(tmp_path / "A.mtx"), "--rhs",
              str(tmp_path / "b.mtx"), "--ref-solution",
              str(tmp_path / "x.mtx"), "--tol", "1e-10", "--testtol", "1e-6",
              *args]
    assert testsolve.main(common + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert jax_testsolve.main(common) == 0
    out_j = capsys.readouterr().out
    assert _iters(out) == _iters(out_j)
    want = "PaddedCSR" if "--no-dia" in args else "DiaMatrix"
    assert f"storage={want}" in out and "device=cpu" in out


def test_testsolve_petsc_float32_and_failure(tmp_path, capsys):
    """PETSc binary input (recognised by its class id) solved in float32,
    and the failure exit codes: 1 above testtol, 2 unconverged."""
    A, b, x = _write_system(tmp_path)
    sp = A.to_scipy().tocoo()
    write_petsc_matrix(str(tmp_path / "A.pmat"), COOMatrix(
        A.nrows, A.nrows, sp.row.astype(np.int32), sp.col.astype(np.int32),
        sp.data))
    write_petsc_vector(str(tmp_path / "b.pmat"), b)
    base = ["--matrix", str(tmp_path / "A.pmat"), "--rhs",
            str(tmp_path / "b.pmat"), "--device", "cpu", "--prec", "ilu0"]
    assert testsolve.main(base + ["--dtype", "float32", "--tol", "1e-5"]) == 0
    assert "dtype=float32" in capsys.readouterr().out
    ref = ["--ref-solution", str(tmp_path / "x.mtx")]
    assert testsolve.main(base + ref + ["--tol", "1e-2",
                                        "--testtol", "1e-12"]) == 1
    assert testsolve.main(base + ["--maxiter", "1", "--tol", "1e-12"]) == 2


def test_compare_solvers_matches_jax(tmp_path, capsys):
    """``compare_solvers``: exact ILU(0) against ILU(0) 4,8 (the CLI's
    defaults), compare_its and issame verdicts and iterations as JAX's."""
    _write_system(tmp_path)
    argv = ["--matrix", str(tmp_path / "A.mtx"), "--tol", "1e-9"]
    rc = compare_solvers.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    rc_j = jax_compare.main(argv)
    out_j = capsys.readouterr().out
    assert rc == rc_j
    for key in ("passed", "ref_iters", "test_iters"):
        assert re.search(f"{key}=(\\S+)", out).group(1) == \
            re.search(f"{key}=(\\S+)", out_j).group(1)
    A, b, _ = poisson3d_system((8, 8, 8), "uniform")
    opts = {"blasted_pc_type": "ilu0", "blasted_async_sweeps": "4,4",
            "rtol": 1e-10}
    res = compare_solvers.compare_solves(A, b, opts, opts, "issame",
                                         device="cpu")
    assert res.passed and res.solution_maxdiff == 0.0
    assert "passed=True" in res.report()
    with pytest.raises(ValueError):
        compare_solvers.compare_solves(A, b, opts, opts, "nope",
                                       device="cpu")


def test_perftest_on_a_small_grid():
    """``run_perf_test`` on the 10³-interior grid: the reference run
    (exact ILU(0)) and two trials, each with the iterations of the port's
    ``solve`` and, for the exact run and ILU(0) 4,4, of JAX's (BiCGSTAB
    with weaker factors is erratic on this Chebyshev grid: 2,2 takes 64
    iterations in the port and 74 in JAX, both to rtol 1e-8); every timing
    positive and finite, speedups and the report."""
    A, b, _ = poisson3d_system((12, 12, 12))
    Aj, bj, _ = jax_poisson3d_system((12, 12, 12))
    base = {"blasted_pc_type": "ilu0", "ksp_type": "bicgstab", "rtol": 1e-8}
    runs = perftest.run_perf_test(A, b, base, [(4, 4), (2, 2)], repeats=1,
                                  device="cpu", sweep_delta=8)
    assert [r.label for r in runs] == ["ref ilu0(-1, -1)", "ilu0(4, 4)",
                                       "ilu0(2, 2)"]
    for r, sw in zip(runs, ("-1,-1", "4,4", "2,2")):
        opts = dict(base, blasted_async_sweeps=sw)
        _, info, _ = api.solve(A, b, opts, device="cpu")
        assert r.converged and r.iters == info.iters
        if sw != "2,2":
            assert r.iters == int(japi.solve(Aj, bj, opts)[1].iters)
        assert r.walltime > 0 and r.precsetup_walltime > 0
        assert 0 < r.apply_slope_ms < 1e4
    assert runs[0].setup_slope_ms == 0.0 and runs[1].setup_slope_ms > 0
    assert runs[0].speedup == 1.0 and runs[1].slope_speedup > 0
    report = perftest.format_report(runs)
    assert len(report.splitlines()) == 4 and "slope-spd" in report
    assert set(vars(runs[0])) == set(vars(perftest.TimingRun()))


@pytest.mark.parametrize("flag,dtype", [([], np.float64),
                                        (["--dtype", "float32"], np.float32)])
def test_perftest_cli_dtype(monkeypatch, capsys, flag, dtype):
    """The CLI's ``--dtype``: the system reaches ``run_perf_test`` in float64
    by default and in float32 when asked (the JAX package's type on a TPU,
    which has no x64: ``perf/PERFTEST_r05.txt``)."""
    seen = []

    def spy(A, b, base, sweep_list, **kw):
        seen.append((A.vals.dtype, sweep_list, base["rtol"], kw["device"]))
        return []

    monkeypatch.setattr(perftest, "run_perf_test", spy)
    perftest.main(["--npts", "6", "--device", "cpu", "--rtol", "1e-5",
                   "--sweeps", "8,6", "4,6", *flag])
    assert seen == [(np.dtype(dtype), [(8, 6), (4, 6)], 1e-5, "cpu")]
    assert "slope-spd" in capsys.readouterr().out


@pytest.mark.parametrize("use_scaling", [False, True])
def test_convergence_history_matches_jax(use_scaling):
    """The per-sweep remainder and L/U errors of the padded ILU(0), to
    1e-10 relative of their first entries."""
    Aj = random_csr(50, density=0.1, seed=6)
    A = CSRMatrix.from_arrays(np.asarray(Aj.rowptr), np.asarray(Aj.colind),
                              np.asarray(Aj.vals))
    got = convergence.ilu_convergence_history(A, 6, use_scaling,
                                              device="cpu")
    want = jconvergence.ilu_convergence_history(Aj, 6, use_scaling)
    for k in ("remainder", "l_error", "u_error"):
        assert got[k].shape == (7,)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10,
                                   atol=1e-10 * abs(want[k][0]))
    assert got["remainder"][-1] < got["remainder"][0]
    assert isinstance(Aj, JaxCSRMatrix)


def test_total_times_matches_jax():
    """``total_times`` over contexts and bare timers, as JAX's."""
    ts = [timing.PrecTimers(1.0, 0.5, 2.0, 1.5, 1, 3),
          timing.PrecTimers(0.25, 0.0, 0.5, 0.25, 2, 4)]
    js = [jtiming.PrecTimers(*vars(t).values()) for t in ts]
    A, b, _ = poisson3d_system((6, 6, 6))
    _, _, ctx = api.solve(A, b, {"blasted_pc_type": "jacobi"}, device="cpu")
    got = timing.total_times(ts + [ctx])
    want = jtiming.total_times(js + [jtiming.PrecTimers(
        *vars(ctx.timers).values())])
    assert vars(got) == vars(want)
    assert got.factor_calls == 4 and got.apply_walltime > 2.5


def test_trace_writes_a_file_per_run(tmp_path):
    """``trace`` writes one Chrome trace per run into the directory, with
    the ``annotate`` span in it; ``trace(None)`` is a no-op."""
    with profiling.trace(None) as prof:
        assert prof is None
    for _ in range(2):
        with profiling.trace(str(tmp_path)) as prof:
            with profiling.annotate("blasted-span"):
                torch.ones(64).sum()
        assert prof is not None
    files = sorted(tmp_path.glob("trace_*.json"))
    assert len(files) == 2
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "blasted-span" for e in events)


def test_maxnorm_and_axpbypcz_match_jax():
    rng = np.random.default_rng(7)
    a, x, y = (rng.standard_normal(33) for _ in range(3))
    t = [torch.from_numpy(v) for v in (a, x, y)]
    assert float(blas1.maxnorm(t[0])) == float(jblas1.maxnorm(jnp.asarray(a)))
    got = blas1.axpbypcz(0.5, t[0], -2.0, t[1], 3.0, t[2])
    want = jblas1.axpbypcz(0.5, jnp.asarray(a), -2.0, jnp.asarray(x), 3.0,
                           jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)
