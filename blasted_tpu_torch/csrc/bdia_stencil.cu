// Block-DIA stencil kernels K5 and K6, the block inverse, the block
// ILU(0) apply sweep K7 and the block head sweep K13, for Hopper (sm_90a),
// templated on float/double and on the block size bs = 2..8 (K7 and K13:
// 1..8).
//
// Hand-written counterparts of the Pallas kernels in
// blasted_tpu/ops/bstencil.py, and of two functions the JAX package leaves
// to XLA: the batched Gauss-Jordan inverse and the SoA apply sweeps of
// blasted_tpu/ops/bdia.py (K7); K13 folds the first two K7 launches of an
// apply chain from zero into one.  Each kernel has a plain PyTorch twin in
// blasted_tpu_torch/ops/bstencil.py with the same contract; the wrappers
// there check every operand and call the C entry points below through
// ctypes.  Built at first CUDA use by blasted_tpu_torch/ops/_cuda.py (one
// nvcc per csrc/*.cu file, in parallel, then linked into one library), with
// the flags of K1-K4: -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.
//
// Layout.  A block diagonal's values are one contiguous (bs*bs, nb) slab:
// row i*bs+j is the stream of block entry (i, j), row-major within a block
// (the container's (k, bs*bs, nb) data, read in place).  Block vectors are
// (nb, bs) arrays, so one block row's bs values are adjacent.  The Pallas
// kernels carry vectors as bs padded 1-D columns with one VMEM halo ring per
// column (_ring_dma, _ring_chunk_reader1d) and restack the coefficients for
// the TPU's sublanes (stack_spmv_coeffs, stack_factor_coeffs); here a
// thread owns block row r and reads the shifted operand at r + o behind a
// bounds check that yields 0 outside [0, nb), as K1 does, so there is no
// padded frame, no ring and no restacking.
//
// What bounds them.  All three move far more bytes than they do flops
// (K6, the densest, does about 1,000 flops per block row at bs = 4 against
// 576 bytes), so each is bound by memory traffic.  Reads of every stream
// are coalesced (neighbouring threads, neighbouring rows).  The shifted
// reads are left to the 50 MB L2: at the g = 128 band (nb = 2,097,152,
// largest offset 16,384) the x window between r - g*g and r is 256 KB at
// bs = 4 in f32 and the Dinv window of K6 1 MB, so each shifted operand
// costs about one pass of device memory.  Simple first: one thread per block
// row in a grid-stride loop, every block product unrolled into registers.
//
// Registers and spills (nvcc -Xptxas -v for sm_90a, CUDA 12.8; the build
// writes the full report beside the library as ptxas_<hash>.log):
//   f32, bs = 4 (the main path): K5 32 registers, K6 64 (either mode), the
//   block inverse 80, no spills.  f32 spills nowhere up to bs = 8 (K6 at
//   bs = 8: 253 registers).  f64 spills in K6 from bs = 6 (bs = 6: up to
//   88 bytes of spill loads, bs = 7: ~740, bs = 8: ~2.7 KB) and in the block
//   inverse at bs = 8 (136 bytes); bs = 4 and 5 in f64 do not spill (K6 126
//   and 168 registers).  K7 takes 32 registers at every bs in f32 up to 7
//   (40 at bs = 8) and 32-48 in f64, in either mode; it never spills.
//   K13 holds the row's own rhs (and, upper, its dinv block) in registers:
//   lower 32-48 (f32) and 32-72 (f64), upper 32-128 (f32) and 32-254 (f64,
//   254 from bs = 7); it never spills.
//
// Arithmetic.  Built with -fmad=false, every product and sum is rounded on
// its own, in the twin's order, and division is IEEE-rounded, so a kernel
// and its twin agree to the last bit.
//
// Every C entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <type_traits>

#include "stencil_common.cuh"

namespace {

using bt::first_row;
using bt::grid_for;
using bt::kThreads;
using bt::make_offsets;
using bt::Offsets;
using bt::row_stride;

__device__ __forceinline__ float abs_of(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_of(double v) { return fabs(v); }

// Batched pivoted Gauss-Jordan inverse of one bs x bs block, step for step
// the elimination of gj_inverse_rows (blasted_tpu/ops/bstencil.py:284-326,
// and its torch twin): the pivot is the FIRST row holding the maximum of
// |M[r][col]| over r >= col (a where-chain, maximum propagating NaN), the
// pivot row is formed as the sum 0 + sum_r (hit_r ? M[r] : 0), it swaps
// with row col, a zero pivot is guarded to 1, and the row is scaled by the
// pivot's reciprocal (1/d, then multiply).  Shared by K6 (out_dinv) and the
// block inverse, as the JAX package shares gj_inverse_rows between its
// kernel and XLA.
template <typename T, int BS>
__device__ __forceinline__ void gj_inverse(const T (&a)[BS * BS],
                                           T (&inv)[BS * BS]) {
  T M[BS][2 * BS];
#pragma unroll
  for (int i = 0; i < BS; ++i) {
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      M[i][j] = a[i * BS + j];
      M[i][BS + j] = (i == j) ? T(1) : T(0);
    }
  }
#pragma unroll
  for (int col = 0; col < BS; ++col) {
    T maxv = abs_of(M[col][col]);
#pragma unroll
    for (int r = col + 1; r < BS; ++r) {
      const T c = abs_of(M[r][col]);
      maxv = (c > maxv || c != c) ? c : maxv;
    }
    bool hit[BS];
    bool found = false;
#pragma unroll
    for (int r = col; r < BS; ++r) {
      hit[r] = (abs_of(M[r][col]) == maxv) && !found;
      found = found || hit[r];
    }
    T piv[2 * BS];
    T cur[2 * BS];
#pragma unroll
    for (int j = 0; j < 2 * BS; ++j) {
      T s = T(0);
#pragma unroll
      for (int r = col; r < BS; ++r) s = s + (hit[r] ? M[r][j] : T(0));
      piv[j] = s;
      cur[j] = M[col][j];
    }
#pragma unroll
    for (int r = col; r < BS; ++r) {
#pragma unroll
      for (int j = 0; j < 2 * BS; ++j) M[r][j] = hit[r] ? cur[j] : M[r][j];
    }
    const T d = piv[col];
    const T dinv = T(1) / (d == T(0) ? T(1) : d);
#pragma unroll
    for (int j = 0; j < 2 * BS; ++j) piv[j] = piv[j] * dinv;
#pragma unroll
    for (int r = 0; r < BS; ++r) {
      if (r == col) {
#pragma unroll
        for (int j = 0; j < 2 * BS; ++j) M[r][j] = piv[j];
      } else {
        const T f = M[r][col];
#pragma unroll
        for (int j = 0; j < 2 * BS; ++j) M[r][j] = M[r][j] - f * piv[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BS; ++i) {
#pragma unroll
    for (int j = 0; j < BS; ++j) inv[i * BS + j] = M[i][BS + j];
  }
}

// K5 — replaces _bspmv_call (blasted_tpu/ops/bstencil.py:188-253).
//   y[r][i] = sum_d sum_j data[d][i*bs+j][r] * x[r + o_d][j]
// summed per output in the twin's order (soa_mv_streams: over d, then j).
// Traffic: (k*bs*bs + 2*bs)*nb elements per call.
template <typename T, int BS>
__global__ void bdia_spmv_kernel(Offsets offs, const T* __restrict__ data,
                                 const T* __restrict__ x, T* __restrict__ y,
                                 long long nb) {
  constexpr int B2 = BS * BS;
  for (long long r = first_row(); r < nb; r += row_stride()) {
    T acc[BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) acc[i] = T(0);
    for (int d = 0; d < offs.k; ++d) {
      const long long q = r + offs.o[d];
      const bool in = q >= 0 && q < nb;
      T xv[BS];
#pragma unroll
      for (int j = 0; j < BS; ++j) xv[j] = in ? x[q * BS + j] : T(0);
      const T* __restrict__ a = data + (long long)d * B2 * nb + r;
#pragma unroll
      for (int i = 0; i < BS; ++i) {
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          const T t = a[(long long)(i * BS + j) * nb] * xv[j];
          acc[i] = (d == 0 && j == 0) ? t : acc[i] + t;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BS; ++i) y[r * BS + i] = acc[i];
  }
}

// K6 — replaces _bfactor_call (blasted_tpu/ops/bstencil.py:384-462).
// One compressed block Chow-Patel sweep (_contract_u0_chunk, :349-381):
//   U0'[i,j] = base0[i,j]
//              - sum_p sum_l (sum_k B_p[i,k] * Dinv[k,l][r + o_p]) * U_p[l,j]
// over the fill pairs p (o_p the pair's lower offset, B_p its lower's base
// values, U_p its upper pre-shifted by o_p), then, with OUT_DINV, the
// block's inverse by the shared Gauss-Jordan.  base0 and dinv are (bs*bs, nb)
// slabs, base_l and ubs (npair, bs*bs, nb).
// Traffic: (1 + 2*npair)*bs*bs + 2*bs*bs streams of nb elements per call.
template <typename T, int BS, bool OUT_DINV>
__global__ void bdia_factor_kernel(Offsets offs, const T* __restrict__ base0,
                                   const T* __restrict__ base_l,
                                   const T* __restrict__ ubs,
                                   const T* __restrict__ dinv,
                                   T* __restrict__ out, long long nb) {
  constexpr int B2 = BS * BS;
  for (long long r = first_row(); r < nb; r += row_stride()) {
    T acc[B2];
#pragma unroll
    for (int c = 0; c < B2; ++c) acc[c] = base0[(long long)c * nb + r];
    for (int p = 0; p < offs.k; ++p) {
      const long long q = r + offs.o[p];
      const bool in = q >= 0 && q < nb;
      const T* __restrict__ bp = base_l + (long long)p * B2 * nb + r;
      const T* __restrict__ up = ubs + (long long)p * B2 * nb + r;
      T D[B2];
      T U[B2];
#pragma unroll
      for (int c = 0; c < B2; ++c) {
        D[c] = in ? dinv[(long long)c * nb + q] : T(0);
        U[c] = up[(long long)c * nb];
      }
#pragma unroll
      for (int i = 0; i < BS; ++i) {
        T b[BS];
#pragma unroll
        for (int k = 0; k < BS; ++k) b[k] = bp[(long long)(i * BS + k) * nb];
        T tmp[BS];
#pragma unroll
        for (int l = 0; l < BS; ++l) {
          T s = b[0] * D[l];
#pragma unroll
          for (int k = 1; k < BS; ++k) s = s + b[k] * D[k * BS + l];
          tmp[l] = s;
        }
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          T t = tmp[0] * U[j];
#pragma unroll
          for (int l = 1; l < BS; ++l) t = t + tmp[l] * U[l * BS + j];
          acc[i * BS + j] = acc[i * BS + j] - t;
        }
      }
    }
    if (OUT_DINV) {
      T inv[B2];
      gj_inverse<T, BS>(acc, inv);
#pragma unroll
      for (int c = 0; c < B2; ++c) out[(long long)c * nb + r] = inv[c];
    } else {
#pragma unroll
      for (int c = 0; c < B2; ++c) out[(long long)c * nb + r] = acc[c];
    }
  }
}

// The block inverse of the factor (Dinv_0 before K6's sweeps, and the
// apply's pre-inverted diagonal): out = GJ(where(mask, a, I)) per block row,
// with mask == nullptr meaning all true.  a and out are (bs*bs, nb) slabs.
// Traffic: 2*bs*bs streams of nb elements (+ nb mask bytes).
template <typename T, int BS>
__global__ void bdia_block_inverse_kernel(const T* __restrict__ a,
                                          const bool* __restrict__ mask,
                                          T* __restrict__ out, long long nb) {
  constexpr int B2 = BS * BS;
  for (long long r = first_row(); r < nb; r += row_stride()) {
    const bool keep = mask == nullptr || mask[r];
    T blk[B2];
#pragma unroll
    for (int i = 0; i < BS; ++i) {
#pragma unroll
      for (int j = 0; j < BS; ++j)
        blk[i * BS + j] = keep ? a[(long long)(i * BS + j) * nb + r]
                               : (i == j ? T(1) : T(0));
    }
    T inv[B2];
    gj_inverse<T, BS>(blk, inv);
#pragma unroll
    for (int c = 0; c < B2; ++c) out[(long long)c * nb + r] = inv[c];
  }
}

// K7 — the block ILU(0) apply sweep, which has no pallas_call in the JAX
// package: XLA fuses soa_unit_lower_sweep (blasted_tpu/ops/bdia.py:66) and
// soa_upper_solve_sweep (:73) inside the fori_loops of
// blasted_tpu/precond/bdia_ilu0.py:455, :461.  One Jacobi sweep on (bs, nb)
// column streams into a fresh output, over the selected block diagonals
// (their indices into data and their offsets, by value):
//   lower: out_i = rhs_i - sum_s sum_j data[idx_s][i*bs+j] * x_j[r + o_s]
//          with rhs = z, x = y (the unit-lower sweep);
//   upper: t_i = rhs_i - (the same sum) with rhs = y, x = z, then
//          out_i = sum_j dinv[i*bs+j] * t_j
// summed per output in the twin's order (soa_mv_streams: over the selected
// diagonals, then j; the first product starts the sum; the Dinv product
// starts at dinv[i*bs] * t_0).  With no selected diagonal the sum is 0.
// What bounds it: memory traffic (2 flops per coefficient, 4-8 bytes each).
// One thread per block row keeps all bs outputs in registers; every stream
// is read coalesced along nb; the shifted column streams are left to L2 as
// K5 leaves x.  The torch form it replaces ran about 30 launches per sweep.
// Traffic: (nsel*bs*bs + 3*bs)*nb elements per call (+ bs*bs*nb upper).
struct Sel {
  int k;
  int idx[BT_MAX_DIAGS];
  long long o[BT_MAX_DIAGS];
};

template <typename T, int BS, bool UPPER>
__global__ void bdia_sweep_kernel(Sel sel, const T* __restrict__ data,
                                  const T* __restrict__ dinv,
                                  const T* __restrict__ rhs,
                                  const T* __restrict__ x,
                                  T* __restrict__ out, long long nb) {
  constexpr int B2 = BS * BS;
  for (long long r = first_row(); r < nb; r += row_stride()) {
    T acc[BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) acc[i] = T(0);
    for (int s = 0; s < sel.k; ++s) {
      const long long q = r + sel.o[s];
      const bool in = q >= 0 && q < nb;
      T xv[BS];
#pragma unroll
      for (int j = 0; j < BS; ++j) xv[j] = in ? x[(long long)j * nb + q] : T(0);
      const T* __restrict__ a = data + (long long)sel.idx[s] * B2 * nb + r;
#pragma unroll
      for (int i = 0; i < BS; ++i) {
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          const T t = a[(long long)(i * BS + j) * nb] * xv[j];
          acc[i] = (s == 0 && j == 0) ? t : acc[i] + t;
        }
      }
    }
    T t[BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) t[i] = rhs[(long long)i * nb + r] - acc[i];
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      if (UPPER) {
        const T* __restrict__ di = dinv + (long long)(i * BS) * nb + r;
        T v = di[0] * t[0];
#pragma unroll
        for (int j = 1; j < BS; ++j) v = v + di[(long long)j * nb] * t[j];
        out[(long long)i * nb + r] = v;
      } else {
        out[(long long)i * nb + r] = t[i];
      }
    }
  }
}

// K13, the block head sweep — the first two K7 launches of a block ILU(0)
// apply chain that starts from zero, in one launch.  From x = 0, K7's first
// sweep gives t = rhs - (+-0) = rhs, so its output is rhs itself (lower)
// or x_q = Dinv_q * rhs_q (upper, the Dinv product in K7's order), and the
// second sweep is
//   lower: out_i = rhs_i - sum_s sum_j data[idx_s][i*bs+j] * rhs_j[r + o_s]
//   upper: t_j = rhs_j - sum_s sum_l data[idx_s][j*bs+l] * x_l[r + o_s],
//          out_i = sum_j dinv[i*bs+j][r] * t_j
// with K7's order of operations throughout.  The upper mode recomputes
// x_q in registers from the neighbour's dinv and rhs, read through L2 as
// K7 reads its shifted operand, so no iterate is read or written.  On
// finite factors the output equals K7's two launches from zero bit for
// bit (the sign of a zero may differ).  Reads beyond the ends give 0; out
// must not alias rhs.
// The row's own rhs and dinv are read first, into registers, so that the
// next row's reads of the same lines (offset +-1) find them in L1: on the
// card that took the upper mode from 244 to 190 us at ex19's shape (f64,
// bs = 4, nb = 1,048,576) and was as fast or faster at every bs in f32 and
// f64 but one (the lower mode at bs = 5 in f64, +4-15%), despite up to
// 254 registers.  The neighbours' dinv reads are predicated, not branched
// around, so they are in flight together with the blocks' reads.
// Traffic: (nsel*bs*bs + 2*bs)*nb elements per call (+ bs*bs*nb upper),
// against 2*(nsel*bs*bs + 3*bs)*nb (+ 2*bs*bs*nb) and a fill of bs*nb for
// the two K7 launches it replaces.
template <typename T, int BS, bool UPPER>
__global__ void bdia_head_sweep_kernel(Sel sel, const T* __restrict__ data,
                                       const T* __restrict__ dinv,
                                       const T* __restrict__ rhs,
                                       T* __restrict__ out, long long nb) {
  constexpr int B2 = BS * BS;
  for (long long r = first_row(); r < nb; r += row_stride()) {
    T yr[BS];
    T dr[UPPER ? B2 : 1];
#pragma unroll
    for (int i = 0; i < BS; ++i) yr[i] = rhs[(long long)i * nb + r];
    if (UPPER) {
#pragma unroll
      for (int c = 0; c < B2; ++c) dr[c] = dinv[(long long)c * nb + r];
    }
    T acc[BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) acc[i] = T(0);
    for (int s = 0; s < sel.k; ++s) {
      const long long q = r + sel.o[s];
      const bool in = q >= 0 && q < nb;
      T xv[BS];
#pragma unroll
      for (int j = 0; j < BS; ++j)
        xv[j] = in ? rhs[(long long)j * nb + q] : T(0);
      if (UPPER) {
        // outside [0, nb) every term is 0 * 0 = +0, K7's zero read
        T yq[BS];
#pragma unroll
        for (int j = 0; j < BS; ++j) yq[j] = xv[j];
#pragma unroll
        for (int i = 0; i < BS; ++i) {
          const T* __restrict__ di = dinv + (long long)(i * BS) * nb + q;
          T v = (in ? di[0] : T(0)) * yq[0];
#pragma unroll
          for (int j = 1; j < BS; ++j)
            v = v + (in ? di[(long long)j * nb] : T(0)) * yq[j];
          xv[i] = v;
        }
      }
      const T* __restrict__ a = data + (long long)sel.idx[s] * B2 * nb + r;
#pragma unroll
      for (int i = 0; i < BS; ++i) {
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          const T t = a[(long long)(i * BS + j) * nb] * xv[j];
          acc[i] = (s == 0 && j == 0) ? t : acc[i] + t;
        }
      }
    }
    T t[BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) t[i] = yr[i] - acc[i];
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      if (UPPER) {
        T v = dr[i * BS] * t[0];
#pragma unroll
        for (int j = 1; j < BS; ++j) v = v + dr[i * BS + j] * t[j];
        out[(long long)i * nb + r] = v;
      } else {
        out[(long long)i * nb + r] = t[i];
      }
    }
  }
}

// Call f with std::integral_constant<int, bs> for bs in 2..8; false for any
// other block size.
template <typename F>
bool with_block_size(int bs, F&& f) {
  switch (bs) {
    case 2: f(std::integral_constant<int, 2>{}); return true;
    case 3: f(std::integral_constant<int, 3>{}); return true;
    case 4: f(std::integral_constant<int, 4>{}); return true;
    case 5: f(std::integral_constant<int, 5>{}); return true;
    case 6: f(std::integral_constant<int, 6>{}); return true;
    case 7: f(std::integral_constant<int, 7>{}); return true;
    case 8: f(std::integral_constant<int, 8>{}); return true;
    default: return false;
  }
}

template <typename T>
int spmv(const Offsets& o, int bs, const void* data, const void* x, void* y,
         long long nb, cudaStream_t s) {
  const bool ok = with_block_size(bs, [&](auto B) {
    bdia_spmv_kernel<T, decltype(B)::value><<<grid_for(nb), kThreads, 0, s>>>(
        o, (const T*)data, (const T*)x, (T*)y, nb);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

template <typename T>
int factor(const Offsets& o, int bs, int out_dinv, const void* base0,
           const void* base_l, const void* ubs, const void* dinv, void* out,
           long long nb, cudaStream_t s) {
  const bool ok = with_block_size(bs, [&](auto B) {
    constexpr int BS = decltype(B)::value;
    if (out_dinv)
      bdia_factor_kernel<T, BS, true><<<grid_for(nb), kThreads, 0, s>>>(
          o, (const T*)base0, (const T*)base_l, (const T*)ubs,
          (const T*)dinv, (T*)out, nb);
    else
      bdia_factor_kernel<T, BS, false><<<grid_for(nb), kThreads, 0, s>>>(
          o, (const T*)base0, (const T*)base_l, (const T*)ubs,
          (const T*)dinv, (T*)out, nb);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// with_block_size, and bs = 1 besides: the apply sweeps' block sizes.
template <typename F>
bool with_sweep_block_size(int bs, F&& f) {
  if (bs != 1) return with_block_size(bs, f);
  f(std::integral_constant<int, 1>{});
  return true;
}

template <typename T>
int sweep(const Sel& sel, int bs, int upper, const void* data,
          const void* dinv, const void* rhs, const void* x, void* out,
          long long nb, cudaStream_t s) {
  const bool ok = with_sweep_block_size(bs, [&](auto B) {
    constexpr int BS = decltype(B)::value;
    if (upper)
      bdia_sweep_kernel<T, BS, true><<<grid_for(nb), kThreads, 0, s>>>(
          sel, (const T*)data, (const T*)dinv, (const T*)rhs, (const T*)x,
          (T*)out, nb);
    else
      bdia_sweep_kernel<T, BS, false><<<grid_for(nb), kThreads, 0, s>>>(
          sel, (const T*)data, (const T*)dinv, (const T*)rhs, (const T*)x,
          (T*)out, nb);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

template <typename T>
int head_sweep(const Sel& sel, int bs, int upper, const void* data,
               const void* dinv, const void* rhs, void* out, long long nb,
               cudaStream_t s) {
  const bool ok = with_sweep_block_size(bs, [&](auto B) {
    constexpr int BS = decltype(B)::value;
    if (upper)
      bdia_head_sweep_kernel<T, BS, true><<<grid_for(nb), kThreads, 0, s>>>(
          sel, (const T*)data, (const T*)dinv, (const T*)rhs, (T*)out, nb);
    else
      bdia_head_sweep_kernel<T, BS, false><<<grid_for(nb), kThreads, 0, s>>>(
          sel, (const T*)data, (const T*)dinv, (const T*)rhs, (T*)out, nb);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// The selected block diagonals of a K7 or K13 call; false where k is out of
// range.
bool make_sel(const int* idx, const long long* offs, int k, Sel* sel) {
  if (k < 0 || k > BT_MAX_DIAGS) return false;
  sel->k = k;
  for (int d = 0; d < BT_MAX_DIAGS; ++d) {
    sel->idx[d] = d < k ? idx[d] : 0;
    sel->o[d] = d < k ? offs[d] : 0;
  }
  return true;
}

template <typename T>
int block_inverse(int bs, const void* a, const void* mask, void* out,
                  long long nb, cudaStream_t s) {
  const bool ok = with_block_size(bs, [&](auto B) {
    bdia_block_inverse_kernel<T, decltype(B)::value>
        <<<grid_for(nb), kThreads, 0, s>>>((const T*)a, (const bool*)mask,
                                           (T*)out, nb);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float64; bs in 2..8 (bt_bdia_sweep and
// bt_bdia_head_sweep: 1..8).
// Pointers are device pointers except `offs` and `idx`, host arrays.
// Returns a cudaError_t as int (cudaErrorInvalidValue for an unsupported bs
// or dtype).
extern "C" {

int bt_bdia_spmv(const long long* offs, int k, int bs, int dtype,
                 const void* data, const void* x, void* y, long long nb,
                 void* stream) {
  Offsets o;
  if (!make_offsets(offs, k, &o) || k < 1) return (int)cudaErrorInvalidValue;
  if (nb <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return spmv<float>(o, bs, data, x, y, nb, s);
  if (dtype == 1) return spmv<double>(o, bs, data, x, y, nb, s);
  return (int)cudaErrorInvalidValue;
}

int bt_bdia_factor(const long long* offs, int npair, int bs, int dtype,
                   int out_dinv, const void* base0, const void* base_l,
                   const void* ubs, const void* dinv, void* out, long long nb,
                   void* stream) {
  Offsets o;
  if (!make_offsets(offs, npair, &o)) return (int)cudaErrorInvalidValue;
  if (nb <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return factor<float>(o, bs, out_dinv, base0, base_l, ubs, dinv, out, nb,
                         s);
  if (dtype == 1)
    return factor<double>(o, bs, out_dinv, base0, base_l, ubs, dinv, out, nb,
                          s);
  return (int)cudaErrorInvalidValue;
}

int bt_bdia_block_inverse(int bs, int dtype, const void* a, const void* mask,
                          void* out, long long nb, void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return block_inverse<float>(bs, a, mask, out, nb, s);
  if (dtype == 1) return block_inverse<double>(bs, a, mask, out, nb, s);
  return (int)cudaErrorInvalidValue;
}

int bt_bdia_sweep(const int* idx, const long long* offs, int k, int bs,
                  int dtype, int upper, const void* data, const void* dinv,
                  const void* rhs, const void* x, void* out, long long nb,
                  void* stream) {
  Sel sel;
  if (!make_sel(idx, offs, k, &sel) || (upper && dinv == nullptr))
    return (int)cudaErrorInvalidValue;
  if (nb <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return sweep<float>(sel, bs, upper, data, dinv, rhs, x, out, nb, s);
  if (dtype == 1)
    return sweep<double>(sel, bs, upper, data, dinv, rhs, x, out, nb, s);
  return (int)cudaErrorInvalidValue;
}

int bt_bdia_head_sweep(const int* idx, const long long* offs, int k, int bs,
                       int dtype, int upper, const void* data,
                       const void* dinv, const void* rhs, void* out,
                       long long nb, void* stream) {
  Sel sel;
  if (!make_sel(idx, offs, k, &sel) || (upper && dinv == nullptr))
    return (int)cudaErrorInvalidValue;
  if (nb <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return head_sweep<float>(sel, bs, upper, data, dinv, rhs, out, nb, s);
  if (dtype == 1)
    return head_sweep<double>(sel, bs, upper, data, dinv, rhs, out, nb, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
