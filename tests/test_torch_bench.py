"""The port's benchmarks (``blasted_tpu_torch/bench/``) on the CPU: their
byte models and nnz against ``bench.py``'s closed forms, every section run
at a tiny size through the kernels' plain twins, the end-to-end solve held
against ``bench.py::bench_solve``, and the refusal to run without a card.

No test here writes a file: ``bench.py`` is imported (its ``main()``, which
writes ``bench_detail.json``, is never called) and the port's benchmarks
write their detail only from their ``main()``, which refuses the CPU."""

import hashlib
import importlib.util
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasted_tpu.precond.dia_ilu0 import dia_pairs as jax_dia_pairs
from blasted_tpu_torch.bench import amg, common, roofline

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(i1=1, i2=16, reps=3, scalar_g=10, block_g4=6, block_g5=5,
            csr_g=8, npts=12)
OFFSETS = lambda g: (-g * g, -g, -1, 0, 1, g, g * g)   # noqa: E731


def _state(path: Path):
    """A file's presence and content hash."""
    return path.exists() and hashlib.sha256(path.read_bytes()).hexdigest()


# ------------------------------------------------------------ byte models --

@pytest.mark.parametrize("g", [3, 5, 8])
def test_scalar_models_match_bench_py(g):
    """bench.py's scalar closed forms: nnz (:164), SpMV bytes (:248),
    compressed factor (:281-282), apply pair (:312-314), bf16 apply
    (:349-350), with JAX's own pair lists."""
    offsets = OFFSETS(g)
    n, k, isz = g ** 3, 7, 4
    npairs = len(jax_dia_pairs(offsets)[offsets.index(0)])
    kl = sum(1 for o in offsets if o < 0)
    ku = sum(1 for o in offsets if o > 0)
    m = roofline.scalar_models(g)
    assert (m["n"], m["k"]) == (n, k)
    assert m["nnz"] == n + 2 * (g - 1) * g * g * 3
    assert m["spmv"] == (k + 2) * n * isz
    assert m["factor"] == (3 + 2 * npairs) * n * isz
    assert m["apply"] == ((kl + 3) + (ku + 4)) * n * isz
    assert m["apply_bf16"] == ((kl + 3) + (ku + 4)) * n * 2


@pytest.mark.parametrize("bs,g", [(4, 3), (4, 6), (5, 4), (5, 7)])
def test_block_models_match_bench_py(bs, g):
    """bench.py's block closed forms: nnz from the numpy mask (:398-403),
    bspmv = stream bytes (:458, :496), factor (:522-523), apply pair
    (:553-554); and the port's band mask is bench.py's."""
    offsets = OFFSETS(g)
    nb, k, isz = g ** 3, 7, 4
    idx = np.arange(nb)
    i0, j0, k0 = idx % g, (idx // g) % g, idx // (g * g)
    mask_np = np.stack([k0 > 0, j0 > 0, i0 > 0, np.ones(nb, bool),
                        i0 < g - 1, j0 < g - 1, k0 < g - 1])
    npairs = len(jax_dia_pairs(offsets)[offsets.index(0)])
    kl = sum(1 for o in offsets if o < 0)
    ku = sum(1 for o in offsets if o > 0)
    m = roofline.block_models(bs, g)
    assert (m["nb"], m["k"]) == (nb, k)
    assert m["nnz"] == int(mask_np.sum()) * bs * bs
    assert m["bspmv"] == (k * bs * bs + 2 * bs) * nb * isz
    assert m["factor"] == (3 + 2 * npairs) * nb * bs * bs * isz
    assert m["apply"] == ((kl + ku + 1) * bs * bs + 6 * bs) * nb * isz
    np.testing.assert_array_equal(roofline.band_mask(g, "cpu").numpy(),
                                  mask_np)


def test_csr_model_matches_bench_py():
    """bench.py's padded-CSR byte model (:604) and gather count (:607)."""
    g, W = 110, 7
    m = roofline.csr_models(g)
    assert m["bytes_model"] == (2 * W + 2) * g ** 3 * 4
    assert m["nnz"] == g ** 3 * W
    # the port's own int64 column indices put its working set, at bench.py's
    # g = 110, under four times the L2: the detail says so
    assert m["operand_bytes"] < 4 * common.L2_BYTES


# ----------------------------------------------------- sections on the CPU --

@pytest.mark.parametrize("part", roofline.SECTIONS)
def test_section_runs_on_cpu(part):
    """Each section at a tiny size on the CPU twins: no failure, finite
    checksums and fractions in (0, 1.05] (the solve: converged to its
    true residual), every entry stamped, and no kernel launch."""
    s = roofline.Settings(parts=(part,), **TINY)
    fracs, failed, detail = roofline.rehearse_on_cpu(s)
    assert failed == []
    assert len(fracs) == (3 if part in roofline.IN_MIN else 0)
    assert all(0.0 < f <= common.MAX_FRACTION for f in fracs)
    assert detail[f"{part}_launches"]["kernels"] == {}
    timed = [v for v in detail.values() if "ms_per_iter" in v]
    if part == "solve":
        got = detail["solve_bicgstab_diailu0"]
        assert got["converged"] and got["true_relres_f64"] <= 1.1e-5
    else:
        assert timed
    for v in timed:
        assert math.isfinite(v["checksum"])
        assert 0.0 < v["frac_measured_stream"] <= common.MAX_FRACTION
    held = {k[len(part) + 1:-len("_vs_twin")]
            for k in detail if k.endswith("_vs_twin")}
    assert held == HELD.get(part, set())
    for k in held:      # on the CPU the wrapper runs the twin itself
        assert detail[f"{part}_{k}_vs_twin"]["max_abs_err"] == 0.0
    for v in detail.values():
        assert v["stamp"]["device"] == "cpu" and v["stamp"]["parts"] == part


HELD = {"scalar": {"dia_spmv", "factor_u0", "factor_lower",
                   "tri_sweep_lower", "tri_sweep_upper"},
        "block4": {"bspmv", "bfactor_dinv", "bfactor_u0", "block_inverse"},
        "block5": {"bspmv", "bfactor_dinv", "bfactor_u0", "block_inverse"}}


@pytest.mark.parametrize("part,wrapper", [("scalar", "factor_lower_stencil"),
                                          ("block5", "bdia_spmv_stencil")])
def test_kernel_off_its_twin_fails_the_section(monkeypatch, part, wrapper):
    """A kernel whose result leaves its twin's by more than TWIN_RTOL fails
    its section before anything is timed with it."""
    real = getattr(roofline, wrapper)

    def off(*args):
        out = real(*args)
        return out + 1e-3 * out.abs().max()

    monkeypatch.setattr(roofline, wrapper, off)
    s = roofline.Settings(parts=(part,), **TINY)
    fracs, failed, detail = roofline.rehearse_on_cpu(s)
    assert failed == [part] and fracs == [0.0]
    assert "from the twin" in detail[f"{part}_FAILED"]


def test_held_launches_are_uncounted(monkeypatch):
    """Launches made to hold a kernel against its twin leave the counts as
    they were; launches outside the check still count."""
    from blasted_tpu_torch.ops import _cuda

    def kernel():
        _cuda.launches["dia_spmv"] += 1
        _cuda.launches_by_device["dia_spmv"][0] = 1
        return torch.ones(3)

    _cuda.reset_launches()
    b = roofline.Settings(**TINY).bench("cpu", common.cpu_card())
    rec = b.held("probe_vs_twin", kernel, lambda: torch.ones(3))
    assert rec["rel_err"] == 0.0 and rec["rtol"] == 1e-5
    assert common.launched() == {}
    assert _cuda.launches_by_device["dia_spmv"] == {}
    kernel()
    assert common.launched() == {"dia_spmv": 1}
    _cuda.reset_launches()


def test_failed_section_counts_zero(monkeypatch):
    """A section that raises counts 0.0 toward the min and is recorded as
    failed (bench.py's ``guarded``); the others still run."""
    def boom(b, g):
        raise RuntimeError("scalar broke")

    monkeypatch.setattr(roofline, "bench_scalar", boom)
    s = roofline.Settings(parts=("scalar", "block4"), **TINY)
    fracs, failed, detail = roofline.rehearse_on_cpu(s)
    assert failed == ["scalar"] and fracs[0] == 0.0 and len(fracs) == 4
    assert "scalar broke" in detail["scalar_FAILED"]
    assert "block4_bspmv" in detail


def test_summary_line_has_bench_py_keys():
    line = common.summary_line([0.8, 0.35, 0.9])
    import json
    out = json.loads(line)
    assert set(out) == {"metric", "value", "unit", "vs_baseline"}
    assert out["value"] == 0.35 and out["vs_baseline"] == 0.5
    assert json.loads(common.summary_line([]))["value"] == 0.0


def test_impossible_readings_fail():
    b = roofline.Settings(**TINY).bench("cpu", common.cpu_card())
    with pytest.raises(common.MeasurementFault):
        b.record("too_fast", 1e-3, 2_000_000, 1e9)        # 2.0 of the stream
    assert b.detail["too_fast"]["frac_measured_stream"] == 2.0

    def make_run(iters):           # slower at the smaller count
        def run():
            import time
            time.sleep(0.02 if iters == 1 else 0.0)
            return torch.zeros(())
        return run
    with pytest.raises(common.MeasurementFault):
        b.slope(make_run)

    def nan_run(iters):
        return lambda: torch.tensor(float("nan"))
    with pytest.raises(common.MeasurementFault):
        b.slope(nan_run)


def test_settings_read_bench_py_knobs():
    s = roofline.Settings.from_env({})
    assert (s.i1, s.i2, s.reps) == (4, 54, 5)
    assert s.parts == roofline.SECTIONS
    assert (s.scalar_g, s.block_g4, s.block_g5, s.csr_g, s.npts) == \
        (320, 128, 96, 110, 162)
    s = roofline.Settings.from_env({"BENCH_PARTS": "scalar,solve",
                                    "BENCH_I2": "14"})
    assert s.parts == ("scalar", "solve") and s.i2 == 14
    with pytest.raises(ValueError):
        roofline.Settings.from_env({"BENCH_PARTS": "scalar,bogus"})
    a = amg.Settings.from_env({})
    assert (a.npts, a.rtol, a.smoother) == (130, 1e-6, "jacobi")


# ------------------------------------------------- the solve vs bench.py ---

SOLVE_NPTS = 18


def test_solve_matches_bench_py(monkeypatch):
    """The ``solve`` section against ``bench.py::bench_solve`` at npts = 18
    (16³ rows) in float64 (the tests' JAX runs with x64): the same
    iterations and x within 1e-9 of max |x|.  Exact iteration parity holds
    here (C7: a uniform grid at rtol 1e-5 in float64 is not a fixture whose
    count moves with rounding).  bench.py's x is the argument of its
    checksum ``jnp.sum(x)`` after each timed solve, captured by wrapping
    ``jnp.sum``; its main(), which writes bench_detail.json, is not
    called."""
    spec = importlib.util.spec_from_file_location("_bench_reference",
                                                  ROOT / "bench.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.setenv("BENCH_NPTS", str(SOLVE_NPTS))
    n = (SOLVE_NPTS - 2) ** 3
    seen = []
    real_sum = jnp.sum

    def spy(a, *args, **kw):
        if isinstance(a, jax.Array) and not isinstance(a, jax.core.Tracer) \
                and a.shape == (n,):
            seen.append(np.asarray(a))
        return real_sum(a, *args, **kw)

    monkeypatch.setattr(jnp, "sum", spy)
    before = _state(ROOT / "bench_detail.json")
    ref.bench_solve()
    monkeypatch.setattr(jnp, "sum", real_sum)
    assert _state(ROOT / "bench_detail.json") == before
    want = ref.DETAIL["solve_bicgstab_diailu0"]
    x_ref = seen[-1]

    s = roofline.Settings(npts=SOLVE_NPTS)
    b = s.bench("cpu", common.cpu_card())
    x = roofline.bench_solve(b, SOLVE_NPTS, s.solve_sweeps, s.solve_tol,
                             s.solve_maxiter, samples=2, dtype=np.float64)
    got = b.detail["solve_bicgstab_diailu0"]
    assert got["converged"] and want["converged"]
    assert got["iters"] == want["iters"]
    assert got["true_relres_f64"] <= 1.1 * s.solve_tol
    assert got["samples"] == 2 and got["median_seconds"] >= got["seconds"]
    err = np.max(np.abs(x.numpy() - x_ref)) / np.max(np.abs(x_ref))
    assert err <= 1e-9, err


# ------------------------------------------------------------------ AMG ----

def test_amg_runs_on_cpu():
    """bench/amg.py on the CPU at npts = 18: both CG solves converge, the
    hierarchy stays on DIA, the V-cycle needs fewer iterations, no kernel
    launch."""
    e = amg.rehearse_on_cpu(amg.Settings(npts=18))
    a, g = e["amg_cg"], e["sgs_cg"]
    assert a["converged"] and g["converged"]
    assert a["iters"] < g["iters"]
    assert a["true_relres_f64"] <= 1.1e-6 and g["true_relres_f64"] <= 1.1e-6
    assert e["levels"][0] == 16 ** 3 and a["launches"] == {} == g["launches"]
    assert e["speedup_vs_sgs"] > 0 and e["stamp"]["device"] == "cpu"


# -------------------------------------------------- no card, no run, no file

@pytest.mark.parametrize("module", ["roofline", "amg"])
def test_no_card_no_run_no_file(module):
    """Without a CUDA device each benchmark exits 2, prints no result line
    and writes neither its detail file nor bench_detail.json."""
    files = [common.DETAIL_PATH, ROOT / "bench_detail.json"]
    before = [_state(p) for p in files]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", f"blasted_tpu_torch.bench.{module}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2, res.stderr
    assert res.stdout == ""
    assert "no CUDA device" in res.stderr
    assert [_state(p) for p in files] == before
