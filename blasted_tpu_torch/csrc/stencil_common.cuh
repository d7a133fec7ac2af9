// Helpers shared by the stencil kernels of dia_stencil.cu (K1-K4) and
// bdia_stencil.cu (K5, K6 and the block inverse): the by-value offset table,
// the zero-outside-[0, n) shifted read, the exact 0 -> 1 guard, and the
// grid-stride launch shape (also that of krylov_update.cu's K14).
#pragma once

#include <cuda_runtime.h>

// The JAX package's RCM route admits bands of up to 128 diagonals
// (blasted_tpu/factory.py:59); the by-value table is then 1032 bytes, well
// inside the 4 KB of kernel parameter space.
#define BT_MAX_DIAGS 128

namespace bt {

// Diagonal offsets, passed by value in the kernel's parameter space.
struct Offsets {
  int k;
  long long o[BT_MAX_DIAGS];
};

template <typename T>
__device__ __forceinline__ T shifted(const T* __restrict__ x, long long j,
                                     long long n) {
  return (j >= 0 && j < n) ? x[j] : T(0);
}

template <typename T>
__device__ __forceinline__ T guard(T den) {
  return den == T(0) ? T(1) : den;
}

__device__ __forceinline__ long long first_row() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long row_stride() {
  return (long long)gridDim.x * blockDim.x;
}

constexpr int kThreads = 256;
// Four waves of the eight 256-thread blocks each of the H100's 132 SMs
// holds; larger n is covered by the grid-stride loops.
constexpr long long kMaxBlocks = 132 * 8 * 4;

inline dim3 grid_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return dim3((unsigned)(b < kMaxBlocks ? b : kMaxBlocks));
}

inline bool make_offsets(const long long* o, int k, Offsets* out) {
  if (k < 0 || k > BT_MAX_DIAGS) return false;
  out->k = k;
  for (int d = 0; d < k; ++d) out->o[d] = o[d];
  for (int d = k; d < BT_MAX_DIAGS; ++d) out->o[d] = 0;
  return true;
}

}  // namespace bt
