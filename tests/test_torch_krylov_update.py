"""K14, BiCGSTAB's fused vector updates (``ops/krylov_update.py``), on the
CPU: the twins against the solver's former inline expressions, to the bit;
``bicgstab`` against its former loop, to the bit; the rule that sends a
CUDA float32/float64 tensor to the kernels (the kernel library and the
card stubbed), a CUDA tensor of another dtype to an error, a row-sharded
vector to them shard by shard and a CPU tensor to the twins; and a whole
solve, whole and row-sharded, through the kernels' launch path, with the
C entry points' contract computed on the host from the pointers the
wrappers pass."""

import contextlib
import ctypes

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blasted_tpu_torch.apps import poisson3d_system
from blasted_tpu_torch.ops import _cuda
from blasted_tpu_torch.ops import krylov_update as ku
from blasted_tpu_torch.ops.blas1 import dot, guard_zero, norm2, where, \
    zeros_like
from blasted_tpu_torch.ops.spmv import spmv
from blasted_tpu_torch.parallel.mesh import ShardedVector
from blasted_tpu_torch.solvers import SolveInfo, bicgstab
from blasted_tpu_torch.sparse import dia_from_csr
from blasted_tpu_torch.utils import profiling

DTYPES = (torch.float32, torch.float64)
K14 = ("krylov_p_update", "krylov_s_update", "krylov_xr_update")
N = 1001


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    _cuda.reset_launches()
    yield
    profiling.reset()
    _cuda.reset_launches()


def _operands(dtype, brk: bool, lucky: bool, n: int = N, seed: int = 3):
    gen = torch.Generator().manual_seed(seed)
    vec = {k: torch.randn(n, generator=gen, dtype=dtype)
           for k in ("r", "p", "v", "x", "y", "z", "s", "t")}
    sc = {k: torch.randn((), generator=gen, dtype=dtype)
          for k in ("beta", "alpha", "omega")}
    if lucky:
        sc["omega"] = torch.zeros((), dtype=dtype)
    return vec, sc, torch.tensor(brk)


# ------------------------------------------------------- twins, bitwise ----

@pytest.mark.parametrize("lucky", [False, True])
@pytest.mark.parametrize("brk", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_twins_equal_the_former_inline_expressions(dtype, brk, lucky):
    v, sc, flag = _operands(dtype, brk, lucky)
    beta, alpha, omega = sc["beta"], sc["alpha"], sc["omega"]
    want_p = v["r"] + beta * v["p"] - beta * omega * v["v"]
    want_s = v["r"] - alpha * v["v"]
    x_new = v["x"] + alpha * v["y"] + omega * v["z"]
    r_new = v["s"] - omega * v["t"]
    want_x = torch.where(flag, v["x"], x_new)
    want_r = torch.where(flag, v["r"], r_new)
    for p_fn, s_fn, xr_fn in ((ku.p_update_ref, ku.s_update_ref,
                               ku.xr_update_ref),
                              (ku.p_update, ku.s_update, ku.xr_update)):
        assert torch.equal(p_fn(v["r"], v["p"], v["v"], beta, beta * omega),
                           want_p)
        assert torch.equal(s_fn(v["r"], v["v"], alpha), want_s)
        got_x, got_r = xr_fn(v["x"], v["r"], v["y"], v["z"], v["s"], v["t"],
                             alpha, omega, flag)
        assert torch.equal(got_x, want_x) and torch.equal(got_r, want_r)
    assert set(_cuda.launches.values()) == {0}
    assert "krylov.fused_update" not in profiling.counters


# ------------------------------------------- bicgstab against its former loop

def _former_bicgstab(amat, prec, b, x0, tol, maxiter):
    """``solvers/krylov.py::bicgstab`` as it was before K14, spans left
    out: the vector updates inline."""
    dt = b.dtype
    finfo = torch.finfo(dt)
    eps, tiny = finfo.eps, finfo.tiny

    def scalar(val):
        return torch.tensor(val, dtype=dt, device=b.device)

    bnorm = norm2(b)
    r0 = b - amat(x0)
    rhat = r0
    nrhat = norm2(rhat)
    x, r = x0, r0
    p, v = zeros_like(b), zeros_like(b)
    rhoold, alpha, omega = scalar(1.0), scalar(1.0), scalar(1.0)
    resnorm = scalar(100.0)
    breakdown = torch.zeros((), dtype=torch.bool, device=b.device)
    step, done = 0, False
    while step < maxiter and not done:
        rho = dot(rhat, r)
        brk = torch.abs(rho) <= eps * eps * nrhat * norm2(r) + 100 * tiny
        brk = brk | (torch.abs(rhoold * omega) <= 100 * tiny)
        beta = rho * alpha / guard_zero(rhoold * omega)
        p = r + beta * p - beta * omega * v
        y = prec(p)
        v = amat(y)
        rv = dot(rhat, v)
        brk = brk | (torch.abs(rv) <= eps * eps * nrhat * norm2(v) + 100 * tiny)
        alpha = rho / guard_zero(rv)
        rs = r - alpha * v
        z = prec(rs)
        t = amat(z)
        tt = dot(t, t)
        lucky = tt <= 100 * tiny
        omega = torch.where(lucky, torch.zeros_like(tt),
                            dot(t, rs) / guard_zero(tt))
        x_new = x + alpha * y + omega * z
        r_new = rs - omega * t
        resnorm_new = norm2(r_new)
        x = where(brk, x, x_new)
        r = where(brk, r, r_new)
        resnorm = torch.where(brk, resnorm, resnorm_new)
        conv = resnorm / bnorm < tol
        breakdown = breakdown | brk | (lucky & ~conv)
        rhoold = rho
        step += 1
        done = bool(conv | brk | lucky)
    info = SolveInfo(converged=bool(resnorm / bnorm < tol), iters=step,
                     resnorm=float(resnorm), bnorm=float(bnorm),
                     breakdown=bool(breakdown))
    return x, info


def _dense(A, P):
    At, Pt = torch.from_numpy(A), torch.from_numpy(P)
    return (lambda u: At.to(u.dtype) @ u), (lambda u: Pt.to(u.dtype) @ u)


def _fixture(name: str, dtype):
    """(amat, prec, b, tol, maxiter) of ``tests/test_torch_krylov.py``'s
    systems: the DIA Poisson operator with Jacobi, a dense nonsymmetric
    one, the rotation that breaks down and the exact preconditioner's
    lucky half-step."""
    if name == "poisson jacobi":
        A, b, _ = poisson3d_system((10, 10, 10))
        D = dia_from_csr(A.astype(np.dtype(str(dtype)[6:])), "cpu")
        dinv = torch.from_numpy(1.0 / A.to_scipy().diagonal()).to(dtype)
        return ((lambda u: spmv(D, u)), (lambda r: dinv * r),
                torch.from_numpy(b).to(dtype), 1e-10, 500)
    rng = np.random.default_rng({"dense": 7, "lucky": 5}.get(name, 0))
    if name == "dense":
        A = rng.standard_normal((30, 30)) + 8 * np.eye(30)
        return (*_dense(A, np.eye(30)),
                torch.from_numpy(rng.standard_normal(30)).to(dtype), 1e-12,
                100)
    if name == "breakdown":
        A = np.array([[0.0, 1.0], [-1.0, 0.0]])
        return (*_dense(A, np.eye(2)), torch.tensor([1.0, 0.0], dtype=dtype),
                1e-12, 50)
    A = rng.standard_normal((6, 6)) + 6 * np.eye(6)
    return (*_dense(A, np.linalg.inv(A)),
            torch.from_numpy(rng.standard_normal(6)).to(dtype), 1e-10, 50)


FIXTURES = ("poisson jacobi", "dense", "breakdown", "lucky")


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bicgstab_equals_its_former_loop_to_the_bit(name, dtype):
    amat, prec, b, tol, maxiter = _fixture(name, dtype)
    x, info = bicgstab(amat, prec, b, torch.zeros_like(b), tol=tol,
                       maxiter=maxiter)
    x0, info0 = _former_bicgstab(amat, prec, b, torch.zeros_like(b), tol,
                                 maxiter)
    assert info == info0
    assert torch.equal(x, x0)
    if name == "breakdown":
        assert info.breakdown and not info.converged
    else:
        assert info.converged


# ------------------------------------------------------- the dispatch rule ----

class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on cuda:0 (its data stays host
    memory, which the stubbed library never reads); ``to`` another card
    relabels it."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    def to(self, device, non_blocking=False):
        return self.as_subclass(_FAKE[torch.device(device).index])


class _FakeCuda2(_FakeCuda):
    """The same, on cuda:2."""

    @property
    def device(self):
        return torch.device("cuda", 2)


_FAKE = {0: _FakeCuda, 2: _FakeCuda2}


class _StubLibrary:
    """Every C entry point returns cudaSuccess and records its name."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append(entry) or 0


@pytest.fixture
def stub_card(monkeypatch):
    """cuda:0 current, a stub kernel library, and ``torch.cuda.device``
    switching the current card (recorded in ``lib.switches``)."""
    lib = _StubLibrary()
    lib.switches, current = [], [0]

    class _Device:
        def __init__(self, device):
            self.index = torch.device(device).index

        def __enter__(self):
            lib.switches.append(self.index)
            self.prev, current[0] = current[0], self.index

        def __exit__(self, *exc):
            current[0] = self.prev

    monkeypatch.setattr(_cuda, "kernels_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0})())
    return lib


def _calls(vec, sc, flag):
    """Each wrapper's call on the operands, by launch name."""
    beta, alpha, omega = sc["beta"], sc["alpha"], sc["omega"]
    return {
        "krylov_p_update": lambda: ku.p_update(vec["r"], vec["p"], vec["v"],
                                               beta, beta * omega),
        "krylov_s_update": lambda: ku.s_update(vec["r"], vec["v"], alpha),
        "krylov_xr_update": lambda: ku.xr_update(
            vec["x"], vec["r"], vec["y"], vec["z"], vec["s"], vec["t"],
            alpha, omega, flag)}


def _fake(vec, sc, flag):
    as_card = {k: t.as_subclass(_FakeCuda) for k, t in vec.items()}
    return (as_card, {k: t.as_subclass(_FakeCuda) for k, t in sc.items()},
            flag.as_subclass(_FakeCuda))


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_cuda_tensor_reaches_the_launch(stub_card, dtype):
    calls = _calls(*_fake(*_operands(dtype, False, False)))
    for name, call in calls.items():
        out = call()
        for o in (out if isinstance(out, tuple) else (out,)):
            assert isinstance(o, _FakeCuda) and o.shape == (N,)
    assert stub_card.calls == ["bt_" + n for n in K14]
    assert all(_cuda.launches[n] == 1 for n in K14)
    assert _cuda.launches_by_device["krylov_xr_update"] == {0: 1}
    assert profiling.counters["krylov.fused_update"] == 1
    assert stub_card.switches == [0, 0, 0]


def test_a_launch_runs_on_its_operands_card(stub_card):
    """Operands on cuda:2 while cuda:0 is current: each pass makes cuda:2
    current for its launch and is counted there."""
    vec, sc, flag = _operands(torch.float32, False, False, n=8)
    on2 = ({k: t.as_subclass(_FakeCuda2) for k, t in vec.items()},
           {k: t.as_subclass(_FakeCuda2) for k, t in sc.items()},
           flag.as_subclass(_FakeCuda2))
    for call in _calls(*on2).values():
        call()
    assert stub_card.switches == [2, 2, 2]
    assert all(_cuda.launches_by_device[n] == {2: 1} for n in K14)
    assert torch.cuda.current_device() == 0


def test_cpu_tensors_take_the_twins(stub_card):
    """A CPU tensor of any dtype, whole or row-sharded, runs the twins."""
    vec, sc, flag = _operands(torch.float32, False, False, n=8)
    bf = ({k: t.bfloat16() for k, t in vec.items()},
          {k: t.bfloat16() for k, t in sc.items()}, flag)
    for call in [*_calls(*bf).values(), *_calls(vec, sc, flag).values()]:
        call()
    sharded = {k: ShardedVector([t[:4], t[4:]]) for k, t in vec.items()}
    got = _calls(sharded, sc, flag)["krylov_p_update"]()
    assert isinstance(got, ShardedVector)
    want = ku.p_update_ref(vec["r"], vec["p"], vec["v"], sc["beta"],
                           sc["beta"] * sc["omega"])
    assert torch.equal(torch.cat(got.parts), want)
    assert stub_card.calls == []
    assert set(_cuda.launches.values()) == {0}
    assert "krylov.fused_update" not in profiling.counters


def test_a_card_tensor_of_another_dtype_raises(stub_card):
    vec, sc, flag = _operands(torch.float32, False, False, n=8)
    bf = ({k: t.bfloat16().as_subclass(_FakeCuda) for k, t in vec.items()},
          {k: t.bfloat16().as_subclass(_FakeCuda) for k, t in sc.items()},
          flag.as_subclass(_FakeCuda))
    for call in _calls(*bf).values():
        with pytest.raises(TypeError, match="float32/float64"):
            call()
    assert stub_card.calls == []


def test_a_sharded_vector_launches_on_each_shard(stub_card):
    """Shards on cuda:0 and cuda:2, the scalars on cuda:0 (the first
    shard's device): each pass launches once on each shard's card, and the
    x-and-r pass counts one fused update for the whole vector."""
    vec, sc, flag = _operands(torch.float64, False, False, n=8)
    sharded = {k: ShardedVector([t[:4].as_subclass(_FakeCuda),
                                 t[4:].as_subclass(_FakeCuda2)])
               for k, t in vec.items()}
    scalars = {k: t.as_subclass(_FakeCuda) for k, t in sc.items()}
    for call in _calls(sharded, scalars, flag.as_subclass(_FakeCuda)
                       ).values():
        out = call()
        for o in (out if isinstance(out, tuple) else (out,)):
            assert isinstance(o, ShardedVector)
            assert [type(p) for p in o.parts] == [_FakeCuda, _FakeCuda2]
            assert [p.shape for p in o.parts] == [(4,), (4,)]
    assert stub_card.calls == ["bt_" + n for n in K14 for _ in range(2)]
    assert all(_cuda.launches_by_device[n] == {0: 1, 2: 1} for n in K14)
    assert profiling.counters["krylov.fused_update"] == 1
    assert stub_card.switches == [0, 2] * 3


@pytest.mark.parametrize("fault,exc", [
    ("non-contiguous", ValueError), ("mixed dtype", TypeError),
    ("short vector", TypeError), ("scalar not 0-d", TypeError),
    ("flag not bool", TypeError)])
def test_the_kernel_path_refuses_bad_operands(stub_card, fault, exc):
    vec, sc, flag = _fake(*_operands(torch.float32, False, False))
    if fault == "non-contiguous":
        vec["v"] = torch.randn(2 * N)[::2].as_subclass(_FakeCuda)
    elif fault == "mixed dtype":
        vec["v"] = vec["v"].double()
    elif fault == "short vector":
        vec["v"] = vec["v"][1:]
    elif fault == "scalar not 0-d":
        sc["alpha"] = sc["alpha"].reshape(1)
    else:
        flag = torch.tensor(0.0).as_subclass(_FakeCuda)
    calls = _calls(vec, sc, flag)
    name = {"scalar not 0-d": "krylov_s_update",
            "flag not bool": "krylov_xr_update"}.get(fault, "krylov_s_update")
    with pytest.raises(exc):
        calls[name]()
    assert stub_card.calls == []


# -------------------------------------- a whole solve through the launches ----

def _host_array(ptr: int, n: int, dtype):
    ctype = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double,
             torch.bool: ctypes.c_bool}[dtype]
    return torch.from_numpy(np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(n,)))


def _host_launch(name, entry, device, dcode, *args):
    """The C entry point ``entry``'s contract (``csrc/krylov_update.cu``)
    computed on host memory from the pointers and length the wrapper
    passes; counted as ``_cuda.launch`` counts."""
    dtype = DTYPES[dcode]
    *ptrs, n = args

    def vec(i):
        return _host_array(ptrs[i], n, dtype)

    def sc(i, dt=dtype):
        return _host_array(ptrs[i], 1, dt)[0]

    if entry == "bt_krylov_p_update":
        vec(5)[:] = vec(0) + sc(3) * vec(1) - sc(4) * vec(2)
    elif entry == "bt_krylov_s_update":
        vec(3)[:] = vec(0) - sc(2) * vec(1)
    else:
        assert entry == "bt_krylov_xr_update"
        if bool(sc(8, torch.bool)):
            vec(9)[:], vec(10)[:] = vec(0), vec(1)
        else:
            vec(9)[:] = vec(0) + sc(6) * vec(2) + sc(7) * vec(3)
            vec(10)[:] = vec(4) - sc(7) * vec(5)
    _cuda.launches[name] += 1


def _sharded(amat, prec, b):
    """The fixture over two row shards: the operator and preconditioner
    applied to the whole vector and split again."""
    def split(u):
        return ShardedVector(u.chunk(2))

    def whole(fn):
        return lambda u: split(fn(torch.cat(u.parts)))

    return whole(amat), whole(prec), split(b)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_solve_through_the_kernels_launches_three_an_iteration(
        monkeypatch, name, dtype, shards):
    """CPU tensors taken for card tensors: each iteration launches each
    pass once on each row shard and counts one fused update, the
    ``krylov.iter`` spans equal ``SolveInfo.iters`` (C5), and x and
    SolveInfo equal the twins' run to the bit."""
    amat, prec, b, tol, maxiter = _fixture(name, dtype)
    if shards == 2:
        amat, prec, b = _sharded(amat, prec, b)
    x0, info0 = bicgstab(amat, prec, b, zeros_like(b), tol=tol,
                         maxiter=maxiter)
    monkeypatch.setattr(ku, "takes_kernel",
                        lambda v: v.dtype in DTYPES)
    monkeypatch.setattr(_cuda, "launch", _host_launch)
    # the CPU tensors stand for tensors on the current card
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        x, info = bicgstab(amat, prec, b, zeros_like(b), tol=tol,
                           maxiter=maxiter)
    assert info == info0
    if shards == 2:
        x, x0 = torch.cat(x.parts), torch.cat(x0.parts)
    assert torch.equal(x, x0)
    assert {n: _cuda.launches[n] for n in K14} == dict.fromkeys(
        K14, shards * info.iters)
    assert profiling.counters["krylov.fused_update"] == info.iters
    spans = [r for r in profiling.records() if r.name == "krylov.iter"]
    assert len(spans) == info.iters
