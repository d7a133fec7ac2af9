// DIA-stencil kernels K1-K4, K8 and K12 (the zero-start ILU(0) apply
// sweep) for Hopper (sm_90a), templated on float/double.
//
// Hand-written counterparts of the Pallas kernels in
// blasted_tpu/ops/stencil.py (K1-K4), of the plain Chow-Patel factor
// sweep that the JAX package leaves to XLA (K8), and a fold of an apply
// chain's first two K2 sweeps from zero into one (K12).  Each kernel has a
// plain PyTorch twin in blasted_tpu_torch/ops/stencil.py with the same
// contract; the wrappers there check every operand and call the C entry
// points below through ctypes.  Build (done at first CUDA use by
// blasted_tpu_torch/ops/_cuda.py, which compiles every csrc/*.cu this way
// and links them into one library):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -Xcompiler -fPIC -c -o dia_stencil.o dia_stencil.cu
//
// Layout.  Diagonal-indexed operands are one stacked, contiguous (k, n)
// array: row d is the stream of diagonal d.  Vectors are plain (n,) arrays.
// The Pallas kernels carry vectors in a padded frame (one zero tile of T
// elements each side) and keep a 3-tile halo window of the shifted vector in
// a VMEM ring fed by DMA.  Here a thread owns row i and reads x[i + o]
// behind a bounds check that yields 0 outside [0, n) — the semantics of
// shift_read — so there is no padded frame, no ring and no tile plan.
//
// What bounds them.  Every kernel does O(1) flops per element it moves, far
// below the card's flop-to-byte ratio: each is bound by memory traffic.  The
// design answers that with coalesced loads (neighbouring threads read
// neighbouring addresses of every stream) and by leaving the shifted reads
// of the vector to the 50 MB L2: at the main path's npts=162 band (n =
// 4,096,000, halo 25,600) the f32 vector is 16 MB, so its k shifted reads
// cost about one pass of device memory, not k.  Simple first: one thread per
// row in a grid-stride loop; TMA staging and tuning are later work.
//
// Arithmetic.  Built with -fmad=false so that every product and sum is
// rounded on its own, as the twin rounds it: the twin runs the same
// operations in the same order, and division is IEEE-rounded on both, so a
// kernel and its twin agree to the last bit.
//
// Every C entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include "stencil_common.cuh"

namespace {

using bt::first_row;
using bt::guard;
using bt::grid_for;
using bt::kThreads;
using bt::make_offsets;
using bt::Offsets;
using bt::row_stride;
using bt::shifted;

// K1 — replaces _spmv_call (blasted_tpu/ops/stencil.py:190-233).
//   y[i] = sum_d data[d][i] * x[i + o_d]
// Traffic: (k + 2)·n elements per call (k coefficient streams, x, y).
template <typename T>
__global__ void dia_spmv_kernel(Offsets offs, const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y,
                                long long n) {
  for (long long i = first_row(); i < n; i += row_stride()) {
    T acc = data[i] * shifted(x, i + offs.o[0], n);
    for (int d = 1; d < offs.k; ++d)
      acc = acc + data[d * n + i] * shifted(x, i + offs.o[d], n);
    y[i] = acc;
  }
}

// K2 — replaces _tri_sweep_call (blasted_tpu/ops/stencil.py:245-307).
// One Jacobi sweep on a triangular factor:
//   out[i] = (rhs[i] - sum_j c[j][i] * y[i + o_j]) * (dinv[i] | 1)
// The unit-lower sweep passes the negative offsets and dinv == nullptr; the
// upper sweep passes the positive offsets and dinv.  out must not alias y.
// Traffic: (m + 3)·n elements per call (+ n with dinv).
template <typename T>
__global__ void tri_sweep_kernel(Offsets offs, const T* __restrict__ coeff,
                                 const T* __restrict__ rhs,
                                 const T* __restrict__ dinv,
                                 const T* __restrict__ y, T* __restrict__ out,
                                 long long n) {
  for (long long i = first_row(); i < n; i += row_stride()) {
    T acc = rhs[i];
    for (int j = 0; j < offs.k; ++j)
      acc = acc - coeff[j * n + i] * shifted(y, i + offs.o[j], n);
    if (dinv != nullptr) acc = acc * dinv[i];
    out[i] = acc;
  }
}

// K12, the zero-start sweep — the first two K2 launches of an ILU(0) apply
// chain that starts from zero, in one launch.  From y0 = 0, K2's first
// sweep yields the right-hand side (unit lower) or rhs * dinv (upper), so
// its second sweep is
//   lower: out[i] = rhs[i] - sum_j c[j][i] * rhs[i + o_j]
//   upper: out[i] = (rhs[i] - sum_j c[j][i] * (rhs[i + o_j] * dinv[i + o_j]))
//                   * dinv[i]
// with K2's order of operations: each neighbour's rhs * dinv is the one
// product the first sweep rounded, so on finite factors the output equals
// the two K2 launches bit for bit (the sign of a zero may differ).  Reads
// beyond the ends give 0, as shifted() does.  out must not alias rhs.
// Traffic: (m + 2)·n elements per call (+ n with dinv), against
// (m + 3)·n + (m + 3)·n (+ 2n) and a fill of n for the chain it replaces.
template <typename T, bool kUpper>
__global__ void zero_start_sweep_kernel(Offsets offs,
                                        const T* __restrict__ coeff,
                                        const T* __restrict__ rhs,
                                        const T* __restrict__ dinv,
                                        T* __restrict__ out, long long n) {
  for (long long i = first_row(); i < n; i += row_stride()) {
    T acc = rhs[i];
    for (int j = 0; j < offs.k; ++j) {
      const long long c = i + offs.o[j];
      T v = T(0);
      if (c >= 0 && c < n) v = kUpper ? rhs[c] * dinv[c] : rhs[c];
      acc = acc - coeff[j * n + i] * v;
    }
    if (kUpper) acc = acc * dinv[i];
    out[i] = acc;
  }
}

// K3 — replaces _factor_u0_call (blasted_tpu/ops/stencil.py:338-394).
// One compressed Chow-Patel sweep; u0 is the only evolving state:
//   u0'[i] = base0[i] - sum_j (base_l[j][i] / guard(u0[i + o_j])) * ubs[j][i]
// over the fill pairs j (o_j the pair's lower offset, ubs the pair-upper
// pre-shifted by o_j), with guard(0) = 1 exactly.
// Traffic: (2·npair + 3)·n elements per call.
template <typename T>
__global__ void factor_u0_kernel(Offsets offs, const T* __restrict__ base0,
                                 const T* __restrict__ base_l,
                                 const T* __restrict__ ubs,
                                 const T* __restrict__ u0,
                                 T* __restrict__ out, long long n) {
  for (long long i = first_row(); i < n; i += row_stride()) {
    T s = base0[i];
    for (int j = 0; j < offs.k; ++j) {
      T den = guard(shifted(u0, i + offs.o[j], n));
      s = s - (base_l[j * n + i] / den) * ubs[j * n + i];
    }
    out[i] = s;
  }
}

// K4 — replaces _factor_lower_call (blasted_tpu/ops/stencil.py:397-447).
// The lowers of the final factor, from the second-to-last u0 iterate:
//   l[j][i] = base_l[j][i] / guard(u0[i + o_j])
// Traffic: (2·kl + 1)·n elements per call.
template <typename T>
__global__ void factor_lower_kernel(Offsets offs, const T* __restrict__ base_l,
                                    const T* __restrict__ u0,
                                    T* __restrict__ out, long long n) {
  for (long long i = first_row(); i < n; i += row_stride()) {
    for (int j = 0; j < offs.k; ++j)
      out[j * n + i] = base_l[j * n + i] / guard(shifted(u0, i + offs.o[j], n));
  }
}


// K8 — the plain Chow-Patel factor sweep, which has no pallas_call in the
// JAX package: XLA fuses dia_factor_sweep_tuple
// (blasted_tpu/precond/dia_ilu0.py:75, looped at :245) and dia_factor_sweep
// (:57, looped under fori_loop at blasted_tpu/parallel/dist_dia.py:159).
// One Jacobi-style sweep from the previous iterate into a fresh (k, n)
// output; per diagonal d of offset o:
//   s = base[d][i] - sum_p ilu[dl_p][i] * ilu[du_p][i + o1_p]
//   s = s / guard(ilu[d0][i + o])          (o < 0)
//   out[d][i] = mask[d][i] ? s : 0          (where the diagonal re-masks)
// and a pass-through diagonal (the tuple form's pair-free uppers) copies
// ilu[d][i].  The pair lists, the pass-through and re-mask flags live in one
// int64 device table built once per preconditioner or shard
// (ops/stencil.py::PlainSweepPlan), never copied from the host per sweep:
//   table[0..k]            first pair of each diagonal (k + 1 entries)
//   table[k+1..2k]         flags per diagonal (kPassThrough | kMasked)
//   table[2k+1 + 3p + 0..2] pair p: dl, du, o1
// Every thread reads the same table entries, so they are broadcast from L1.
// What bounds it: memory traffic, about 1 flop per byte.  At [main]'s
// 7-point band it reads 4 base rows and the 7 ilu rows and writes all 7
// output rows, pass-through rows included (18 streams of n; the twin's
// torch.stack writes them too).  Reads are coalesced along i; the shifted
// reads of ilu are left to L2 as K1's are.
// Traffic: (rows read + k)·n elements (+ n mask bytes per re-masked row).
// Registers (nvcc -Xptxas -v, sm_90a): 32 in f32, 40 in f64, no spills.
constexpr long long kPassThrough = 1;
constexpr long long kMasked = 2;

template <typename T>
__global__ void plain_factor_sweep_kernel(Offsets offs, int d0,
                                          const long long* __restrict__ table,
                                          const T* __restrict__ base,
                                          const T* __restrict__ ilu,
                                          const bool* __restrict__ mask,
                                          T* __restrict__ out, long long n) {
  const int k = offs.k;
  const long long* __restrict__ start = table;
  const long long* __restrict__ flags = table + k + 1;
  const long long* __restrict__ pair = table + 2 * k + 1;
  const T* __restrict__ udiag = ilu + (long long)d0 * n;
  for (long long i = first_row(); i < n; i += row_stride()) {
    for (int d = 0; d < k; ++d) {
      const long long f = flags[d];
      const long long row = (long long)d * n + i;
      if (f & kPassThrough) {
        out[row] = ilu[row];
        continue;
      }
      T s = base[row];
      for (long long p = start[d]; p < start[d + 1]; ++p) {
        const long long dl = pair[3 * p], du = pair[3 * p + 1];
        const long long o1 = pair[3 * p + 2];
        s = s - ilu[dl * n + i] * shifted(ilu + du * n, i + o1, n);
      }
      const long long o = offs.o[d];
      if (o < 0) s = s / guard(shifted(udiag, i + o, n));
      if (f & kMasked) s = mask[row] ? s : T(0);
      out[row] = s;
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  Pointers are device pointers except
// `offs`, a host array of k offsets (K8's `table` lies on the device).
// Returns a cudaError_t as int.
extern "C" {

int bt_dia_spmv(const long long* offs, int k, int dtype, const void* data,
                const void* x, void* y, long long n, void* stream) {
  Offsets o;
  if (!make_offsets(offs, k, &o) || k < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    dia_spmv_kernel<float><<<grid_for(n), kThreads, 0, s>>>(
        o, (const float*)data, (const float*)x, (float*)y, n);
  else if (dtype == 1)
    dia_spmv_kernel<double><<<grid_for(n), kThreads, 0, s>>>(
        o, (const double*)data, (const double*)x, (double*)y, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int bt_tri_sweep(const long long* offs, int k, int dtype, const void* coeff,
                 const void* rhs, const void* dinv, const void* y, void* out,
                 long long n, void* stream) {
  Offsets o;
  if (!make_offsets(offs, k, &o)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    tri_sweep_kernel<float><<<grid_for(n), kThreads, 0, s>>>(
        o, (const float*)coeff, (const float*)rhs, (const float*)dinv,
        (const float*)y, (float*)out, n);
  else if (dtype == 1)
    tri_sweep_kernel<double><<<grid_for(n), kThreads, 0, s>>>(
        o, (const double*)coeff, (const double*)rhs, (const double*)dinv,
        (const double*)y, (double*)out, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int bt_zero_start_sweep(const long long* offs, int k, int dtype, int upper,
                        const void* coeff, const void* rhs, const void* dinv,
                        void* out, long long n, void* stream) {
  Offsets o;
  if (!make_offsets(offs, k, &o) || (upper && dinv == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && upper)
    zero_start_sweep_kernel<float, true><<<grid_for(n), kThreads, 0, s>>>(
        o, (const float*)coeff, (const float*)rhs, (const float*)dinv,
        (float*)out, n);
  else if (dtype == 0)
    zero_start_sweep_kernel<float, false><<<grid_for(n), kThreads, 0, s>>>(
        o, (const float*)coeff, (const float*)rhs, nullptr, (float*)out, n);
  else if (dtype == 1 && upper)
    zero_start_sweep_kernel<double, true><<<grid_for(n), kThreads, 0, s>>>(
        o, (const double*)coeff, (const double*)rhs, (const double*)dinv,
        (double*)out, n);
  else if (dtype == 1)
    zero_start_sweep_kernel<double, false><<<grid_for(n), kThreads, 0, s>>>(
        o, (const double*)coeff, (const double*)rhs, nullptr, (double*)out,
        n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int bt_factor_u0(const long long* offs, int k, int dtype, const void* base0,
                 const void* base_l, const void* ubs, const void* u0,
                 void* out, long long n, void* stream) {
  Offsets o;
  if (!make_offsets(offs, k, &o)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    factor_u0_kernel<float><<<grid_for(n), kThreads, 0, s>>>(
        o, (const float*)base0, (const float*)base_l, (const float*)ubs,
        (const float*)u0, (float*)out, n);
  else if (dtype == 1)
    factor_u0_kernel<double><<<grid_for(n), kThreads, 0, s>>>(
        o, (const double*)base0, (const double*)base_l, (const double*)ubs,
        (const double*)u0, (double*)out, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int bt_factor_lower(const long long* offs, int k, int dtype,
                    const void* base_l, const void* u0, void* out,
                    long long n, void* stream) {
  Offsets o;
  if (!make_offsets(offs, k, &o)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    factor_lower_kernel<float><<<grid_for(n), kThreads, 0, s>>>(
        o, (const float*)base_l, (const float*)u0, (float*)out, n);
  else if (dtype == 1)
    factor_lower_kernel<double><<<grid_for(n), kThreads, 0, s>>>(
        o, (const double*)base_l, (const double*)u0, (double*)out, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int bt_plain_factor_sweep(const long long* offs, int k, int dtype, int d0,
                          const void* table, const void* base,
                          const void* ilu, const void* mask, void* out,
                          long long n, void* stream) {
  Offsets o;
  if (!make_offsets(offs, k, &o) || k < 1 || d0 < 0 || d0 >= k)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* t = (const long long*)table;
  if (dtype == 0)
    plain_factor_sweep_kernel<float><<<grid_for(n), kThreads, 0, s>>>(
        o, d0, t, (const float*)base, (const float*)ilu, (const bool*)mask,
        (float*)out, n);
  else if (dtype == 1)
    plain_factor_sweep_kernel<double><<<grid_for(n), kThreads, 0, s>>>(
        o, d0, t, (const double*)base, (const double*)ilu, (const bool*)mask,
        (double*)out, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
