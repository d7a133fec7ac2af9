// K14 — BiCGSTAB's vector updates (solvers/krylov.py::bicgstab) in three
// fused passes for Hopper (sm_90a), templated on float/double.
//
// The JAX package leaves these updates to XLA (blasted_tpu/solvers/krylov.py
// bicgstab: the p, s, x and r lines of its loop body); there is no Pallas
// kernel behind them.  In PyTorch each line is a chain of elementwise
// kernels, each reading its operands from device memory and writing a
// temporary back: one iteration's updates run 14 kernels over 36 (n,)
// streams.  Fused, they move the 14 streams the mathematics needs:
//
//   krylov_p_update_kernel:  p_out = (r + beta·p) − bo·v    (r, p, v; p_out)
//   krylov_s_update_kernel:  s     = r − alpha·v            (r, v; s)
//   krylov_xr_update_kernel: x_out = (x + alpha·y) + omega·z,
//                            r_out = s − omega·t             (x, y, z, s, t;
//                                                             x_out, r_out)
//
// where bo is the 0-d beta·omega the solver computes.  Where the 0-d
// breakdown flag brk holds, the xr pass copies x and r instead (the solver
// keeps the previous finite iterate): 4 streams.  The scalars stay on the
// card: each kernel reads them through device pointers, so the host reads
// nothing (one host read per iteration stays the solver's done flag).
// Each pass has a plain PyTorch twin in blasted_tpu_torch/ops/krylov_update.py
// with the same contract; the wrappers there check every operand and call
// the C entry points below through ctypes.  Build (done at first CUDA use by
// blasted_tpu_torch/ops/_cuda.py, with every csrc/*.cu):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -Xcompiler -fPIC -c -o krylov_update.o krylov_update.cu
//
// What bounds them.  One or two operations per value moved: each pass is
// bound by memory traffic.  The design answers that with 16-byte loads and
// stores (four floats or two doubles a thread and step: the card's widest
// access), neighbouring threads on neighbouring addresses, in a
// grid-stride loop, and a scalar tail for the last n mod W values.  An
// operand that is not 16-byte aligned (a view into a larger tensor) takes
// the same kernel with one value a step.
//
// Arithmetic.  Built with -fmad=false, every product and sum is rounded on
// its own, in the order PyTorch evaluates the solver's expressions
// (``r + beta * p - bo * v`` is (r + (beta·p)) − (bo·v)); the kernels only
// multiply, add, subtract and select, so each equals PyTorch's own
// elementwise kernels, and the twin, to the last bit.
//
// Every C entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cstdint>

#include "stencil_common.cuh"

namespace {

using bt::first_row;
using bt::grid_for;
using bt::kThreads;
using bt::row_stride;

// W values of T moved by one load or store (16 bytes where W·sizeof(T) is).
template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
  T v[W];
};

template <typename T, int W>
__device__ __forceinline__ Pack<T, W> load(const T* __restrict__ a,
                                           long long j) {
  return reinterpret_cast<const Pack<T, W>*>(a)[j];
}

template <typename T, int W>
__device__ __forceinline__ void store(T* __restrict__ a, long long j,
                                      const Pack<T, W>& p) {
  reinterpret_cast<Pack<T, W>*>(a)[j] = p;
}

template <typename T>
__device__ __forceinline__ T p_value(T r, T p, T v, T beta, T bo) {
  const T rp = r + beta * p;
  return rp - bo * v;
}

template <typename T>
__device__ __forceinline__ T x_value(T x, T y, T z, T alpha, T omega) {
  const T xy = x + alpha * y;
  return xy + omega * z;
}

// a − c·b: the s pass (r − alpha·v) and the r of the xr pass (s − omega·t)
template <typename T>
__device__ __forceinline__ T sub_scaled(T a, T b, T c) {
  return a - c * b;
}

// K14, the p pass: 4 streams.
template <typename T, int W>
__global__ void krylov_p_update_kernel(const T* __restrict__ r,
                                       const T* __restrict__ p,
                                       const T* __restrict__ v,
                                       const T* __restrict__ beta_,
                                       const T* __restrict__ bo_,
                                       T* __restrict__ out, long long n) {
  const T beta = *beta_, bo = *bo_;
  const long long nw = n / W;
  for (long long j = first_row(); j < nw; j += row_stride()) {
    const Pack<T, W> a = load<T, W>(r, j), b = load<T, W>(p, j),
                     c = load<T, W>(v, j);
    Pack<T, W> o;
#pragma unroll
    for (int k = 0; k < W; ++k)
      o.v[k] = p_value(a.v[k], b.v[k], c.v[k], beta, bo);
    store<T, W>(out, j, o);
  }
  for (long long i = nw * W + first_row(); i < n; i += row_stride())
    out[i] = p_value(r[i], p[i], v[i], beta, bo);
}

// K14, the s pass: 3 streams.
template <typename T, int W>
__global__ void krylov_s_update_kernel(const T* __restrict__ r,
                                       const T* __restrict__ v,
                                       const T* __restrict__ alpha_,
                                       T* __restrict__ out, long long n) {
  const T alpha = *alpha_;
  const long long nw = n / W;
  for (long long j = first_row(); j < nw; j += row_stride()) {
    const Pack<T, W> a = load<T, W>(r, j), c = load<T, W>(v, j);
    Pack<T, W> o;
#pragma unroll
    for (int k = 0; k < W; ++k) o.v[k] = sub_scaled(a.v[k], c.v[k], alpha);
    store<T, W>(out, j, o);
  }
  for (long long i = nw * W + first_row(); i < n; i += row_stride())
    out[i] = sub_scaled(r[i], v[i], alpha);
}

// K14, the x and r pass: 7 streams, or 4 (a copy of x and r) on breakdown.
template <typename T, int W>
__global__ void krylov_xr_update_kernel(
    const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ y,
    const T* __restrict__ z, const T* __restrict__ s, const T* __restrict__ t,
    const T* __restrict__ alpha_, const T* __restrict__ omega_,
    const bool* __restrict__ brk_, T* __restrict__ x_out,
    T* __restrict__ r_out, long long n) {
  const long long nw = n / W;
  if (*brk_) {
    for (long long j = first_row(); j < nw; j += row_stride()) {
      store<T, W>(x_out, j, load<T, W>(x, j));
      store<T, W>(r_out, j, load<T, W>(r, j));
    }
    for (long long i = nw * W + first_row(); i < n; i += row_stride()) {
      x_out[i] = x[i];
      r_out[i] = r[i];
    }
    return;
  }
  const T alpha = *alpha_, omega = *omega_;
  for (long long j = first_row(); j < nw; j += row_stride()) {
    const Pack<T, W> a = load<T, W>(x, j), b = load<T, W>(y, j),
                     c = load<T, W>(z, j), d = load<T, W>(s, j),
                     e = load<T, W>(t, j);
    Pack<T, W> xo, ro;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      xo.v[k] = x_value(a.v[k], b.v[k], c.v[k], alpha, omega);
      ro.v[k] = sub_scaled(d.v[k], e.v[k], omega);
    }
    store<T, W>(x_out, j, xo);
    store<T, W>(r_out, j, ro);
  }
  for (long long i = nw * W + first_row(); i < n; i += row_stride()) {
    x_out[i] = x_value(x[i], y[i], z[i], alpha, omega);
    r_out[i] = sub_scaled(s[i], t[i], omega);
  }
}

// Whether every pointer is 16-byte aligned (the vector loads may be used).
template <typename... P>
bool aligned16(P... ptrs) {
  return ((reinterpret_cast<std::uintptr_t>(ptrs) % 16 == 0) && ...);
}

// The grid of a pass over n values, W at a step.
inline dim3 grid_of(long long n, int w) {
  return grid_for(n / w > 0 ? n / w : 1);
}

template <typename T>
int p_update(const void* r, const void* p, const void* v, const void* beta,
             const void* bo, void* out, long long n, cudaStream_t s) {
  constexpr int W = 16 / sizeof(T);
  const T *tr = (const T*)r, *tp = (const T*)p, *tv = (const T*)v,
          *tb = (const T*)beta, *tbo = (const T*)bo;
  if (aligned16(r, p, v, out))
    krylov_p_update_kernel<T, W><<<grid_of(n, W), kThreads, 0, s>>>(
        tr, tp, tv, tb, tbo, (T*)out, n);
  else
    krylov_p_update_kernel<T, 1><<<grid_of(n, 1), kThreads, 0, s>>>(
        tr, tp, tv, tb, tbo, (T*)out, n);
  return (int)cudaGetLastError();
}

template <typename T>
int s_update(const void* r, const void* v, const void* alpha, void* out,
             long long n, cudaStream_t s) {
  constexpr int W = 16 / sizeof(T);
  const T *tr = (const T*)r, *tv = (const T*)v, *ta = (const T*)alpha;
  if (aligned16(r, v, out))
    krylov_s_update_kernel<T, W><<<grid_of(n, W), kThreads, 0, s>>>(
        tr, tv, ta, (T*)out, n);
  else
    krylov_s_update_kernel<T, 1><<<grid_of(n, 1), kThreads, 0, s>>>(
        tr, tv, ta, (T*)out, n);
  return (int)cudaGetLastError();
}

template <typename T>
int xr_update(const void* x, const void* r, const void* y, const void* z,
              const void* sv, const void* t, const void* alpha,
              const void* omega, const void* brk, void* x_out, void* r_out,
              long long n, cudaStream_t s) {
  constexpr int W = 16 / sizeof(T);
  const T *tx = (const T*)x, *tr = (const T*)r, *ty = (const T*)y,
          *tz = (const T*)z, *ts = (const T*)sv, *tt = (const T*)t,
          *ta = (const T*)alpha, *to = (const T*)omega;
  const bool* tb = (const bool*)brk;
  if (aligned16(x, r, y, z, sv, t, x_out, r_out))
    krylov_xr_update_kernel<T, W><<<grid_of(n, W), kThreads, 0, s>>>(
        tx, tr, ty, tz, ts, tt, ta, to, tb, (T*)x_out, (T*)r_out, n);
  else
    krylov_xr_update_kernel<T, 1><<<grid_of(n, 1), kThreads, 0, s>>>(
        tx, tr, ty, tz, ts, tt, ta, to, tb, (T*)x_out, (T*)r_out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bt_krylov_p_update(int dtype, const void* r, const void* p, const void* v,
                       const void* beta, const void* bo, void* out,
                       long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return p_update<float>(r, p, v, beta, bo, out, n, s);
  if (dtype == 1) return p_update<double>(r, p, v, beta, bo, out, n, s);
  return (int)cudaErrorInvalidValue;
}

int bt_krylov_s_update(int dtype, const void* r, const void* v,
                       const void* alpha, void* out, long long n,
                       void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return s_update<float>(r, v, alpha, out, n, s);
  if (dtype == 1) return s_update<double>(r, v, alpha, out, n, s);
  return (int)cudaErrorInvalidValue;
}

int bt_krylov_xr_update(int dtype, const void* x, const void* r,
                        const void* y, const void* z, const void* sv,
                        const void* t, const void* alpha, const void* omega,
                        const void* brk, void* x_out, void* r_out,
                        long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return xr_update<float>(x, r, y, z, sv, t, alpha, omega, brk, x_out,
                            r_out, n, s);
  if (dtype == 1)
    return xr_update<double>(x, r, y, z, sv, t, alpha, omega, brk, x_out,
                             r_out, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
