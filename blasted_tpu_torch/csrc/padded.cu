// Padded CSR/BSR kernels K9-K11 for Hopper (sm_90a), templated on
// float/double and on the block size bs = 1..8.
//
// The general (padded) path of the JAX package has no pallas_call: its
// products and sweeps are XLA gathers and reductions.  These kernels are the
// hand-written counterparts of those loops:
//
//   K9   padded_spmv_kernel          y = sum_w V[r,w] x[col[r,w]]
//        (blasted_tpu/ops/spmv.py:23-32 spmv, :51-59 bspmv)
//   K10  padded_sweep_kernel<lower>  out = rhs - sum_w T[r,w] x[col[r,w]]
//        padded_sweep_kernel<upper>  out = Dinv_r (rhs - sum_w ...)
//        (blasted_tpu/ops/sweeps.py:86-98, :157-171; the apply loops of
//        blasted_tpu/precond/ilu0.py:372-392, :608-630)
//   K11  padded_factor_sweep_kernel  one Chow-Patel sweep over the ILU pair
//        lists (blasted_tpu/precond/ilu0.py:304-314, :533-547)
//
// Each has a plain PyTorch twin in blasted_tpu_torch/ops/padded.py with the
// same contract; the wrappers there check every operand and call the C
// entry points below through ctypes.  Built at first CUDA use by
// blasted_tpu_torch/ops/_cuda.py (one nvcc per csrc/*.cu, in parallel, then
// linked into one library) with -gencode arch=compute_90a,code=sm_90a -O3
// -fmad=false.
//
// Layout.  A padded matrix keeps W slots per (block) row: values (n, W) or
// (nb, W, bs, bs), row-major, and int32 column ids (n, W) whose sentinel n
// marks a padded slot; the kernel reads x as 0 there, so the twin's
// zero-extended copy of x has no counterpart.  Vectors are (n,) or (nb, bs).
// K11 works on the flat factor values (nnz,) or (nnzb, bs, bs) and the pair
// lists in CSR form: entry e owns the pairs ptr[e] .. ptr[e+1]-1, each the
// positions (pl, pu) of one l_ik and one u_kc; dtab[e] is -1 for an entry on
// or above the diagonal, else the row of `dsrc` it divides by (scalar: the
// position of u_cc in the previous iterate; block: the column c, a row of
// the previous iterate's inverted diagonal blocks).  Only real pairs are
// stored, two int32 ids each, not the sentinel-padded (nnz, P) int64 lists
// of the symbolic data (2P ids per entry, most of them sentinels).
//
// Thread mapping.  A warp serves 32 / bs rows (entries), bs lanes each; lane
// i of a row computes output component i (K11: row i of the output block).
// A lane reads row i of each value block, bs contiguous elements, so the bs
// lanes of a row read the block's bs*bs elements as one contiguous run and a
// warp's reads of one slot are 32 / bs such runs.  For bs = 1 that is one
// thread per row, reading the row's W values and ids; neighbouring rows are
// W elements apart, and the lines a warp touches at slot w are the lines it
// reads at slot w + 1, so L1 serves the rest of the row.  x[col] is a gather
// left to L2 (the f32 vector of the main path is 16 MB).  Where a lane needs
// the whole row's result (the block upper sweep's product with Dinv), the
// row's lanes exchange it by warp shuffles; rows never straddle warps (bs =
// 3, 5, 6, 7 leave 32 mod bs lanes idle).
//
// What bounds them.  Each does O(bs) flops per element it reads (K11's block
// products O(bs) per value too), far below the card's flop-to-byte ratio:
// all three are bound by memory traffic.  Simple first: no shared memory, no
// TMA; a grid-stride loop over warps.
//
// Registers and spills (nvcc -Xptxas -v for sm_90a; the build writes the
// full report beside the library as ptxas_<hash>.log): K9 32 registers
// (40 at bs = 3 in f32), K10 32-48, K11 32-48 in f32 and 40-72 in f64,
// growing with bs; no instantiation spills.
//
// Arithmetic.  Built with -fmad=false, every product and sum is rounded on
// its own, in the twin's order: each sum over slots (pairs) runs in slot
// order and starts from the first product, a block product sums over j in
// order starting from the j = 0 product, and division is IEEE-rounded, so a
// kernel and its twin agree to the last bit.
//
// Every C entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Four waves of the eight 256-thread blocks each of the H100's 132 SMs
// holds; more rows are covered by the grid-stride loop.
constexpr long long kMaxBlocks = 132 * 8 * 4;
constexpr unsigned kFull = 0xffffffffu;

inline dim3 grid_for(long long rows, int rows_per_warp) {
  const long long warps = (rows + rows_per_warp - 1) / rows_per_warp;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  return dim3((unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks));
}

// The lane's place: its row within the warp's group of rows, its component
// i, whether the lane serves a row at all, and the warp's index and stride.
template <int BS>
struct Lane {
  static constexpr int kRows = 32 / BS;
  int sub, i;
  bool used;
  long long warp, nwarps;
  __device__ Lane() {
    const int lane = threadIdx.x & 31;
    sub = lane / BS;
    i = lane - sub * BS;
    used = sub < kRows;
    warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  }
};

// sum_w V[r,w][i,:] . x[col[r,w]] over the W slots of row r, in slot order,
// each block row product summed over j in order (the twin's
// padded_products, then its sum over w).
template <typename T, int BS>
__device__ __forceinline__ T row_sum(const T* __restrict__ vals,
                                     const int* __restrict__ col,
                                     const T* __restrict__ x, long long r,
                                     int i, long long n, int width) {
  const int* __restrict__ cr = col + r * width;
  const T* __restrict__ vr = vals + (r * width * BS + i) * BS;
  T acc = T(0);
  for (int w = 0; w < width; ++w) {
    const long long c = cr[w];
    const bool in = c < n;
    const T* __restrict__ v = vr + (long long)w * BS * BS;
    T t = v[0] * (in ? x[c * BS] : T(0));
#pragma unroll
    for (int j = 1; j < BS; ++j) t = t + v[j] * (in ? x[c * BS + j] : T(0));
    acc = (w == 0) ? t : acc + t;
  }
  return acc;
}

// K9 — the padded SpMV: y[r,i] = sum_w sum_j V[r,w][i,j] x[col[r,w]][j].
// Traffic: W (bs*bs values + one int32 id) per row, x, y.
template <typename T, int BS>
__global__ void padded_spmv_kernel(const T* __restrict__ vals,
                                   const int* __restrict__ col,
                                   const T* __restrict__ x,
                                   T* __restrict__ y, long long n,
                                   int width) {
  const Lane<BS> L;
  if (!L.used) return;
  for (long long g = L.warp; g * L.kRows < n; g += L.nwarps) {
    const long long r = g * L.kRows + L.sub;
    if (r < n) y[r * BS + L.i] = row_sum<T, BS>(vals, col, x, r, L.i, n, width);
  }
}

// K10 — one Jacobi sweep of the ILU(0) apply on a pre-masked triangle:
//   lower: out = rhs - sum (unit diagonal)
//   upper: out = Dinv_r (rhs - sum), Dinv (n,) or (nb, bs, bs), the block
//          product summed over j in order from dinv[r][i][0] * t_0.
// Traffic: the lower mode's W (values + id) per row, x, rhs, out; the upper
// mode also Dinv.
template <typename T, int BS, bool UPPER>
__global__ void padded_sweep_kernel(const T* __restrict__ vals,
                                    const int* __restrict__ col,
                                    const T* __restrict__ dinv,
                                    const T* __restrict__ rhs,
                                    const T* __restrict__ x,
                                    T* __restrict__ out, long long n,
                                    int width) {
  const Lane<BS> L;
  for (long long g = L.warp; g * L.kRows < n; g += L.nwarps) {
    const long long r = g * L.kRows + L.sub;
    const bool on = L.used && r < n;
    const long long o = r * BS + L.i;
    T t = T(0);
    if (on) t = rhs[o] - row_sum<T, BS>(vals, col, x, r, L.i, n, width);
    if (!UPPER) {
      if (on) out[o] = t;
    } else if (BS == 1) {
      if (on) out[o] = dinv[o] * t;
    } else {
      // every lane of the warp takes part in the shuffles
      const int first = (threadIdx.x & 31) - L.i;
      const T* __restrict__ d = dinv + o * BS;
      T v = T(0);
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        const T tj = __shfl_sync(kFull, t, first + j);
        if (on) v = (j == 0) ? d[0] * tj : v + d[j] * tj;
      }
      if (on) out[o] = v;
    }
  }
}

// K11 — one Chow-Patel sweep from the previous iterate `ilu` into `out`:
//   s_e = base_e - sum_p ilu[pl_p] . ilu[pu_p]   (s_e = base_e with no pair)
//   out_e = s_e / dsrc[dtab_e]   (scalar, dtab_e >= 0)
//         = s_e . dsrc[dtab_e]   (block, dtab_e >= 0)
//         = s_e                  (dtab_e < 0)
// the block products c[i,k] = sum_j a[i,j] b[j,k] in order from j = 0, the
// pair sum in list order from the first product.  Lane i computes row i of
// the entry's block.
// Traffic: per entry base, ilu and out (bs*bs each), ptr and dtab (int32);
// per pair its two int32 positions; dsrc once.
template <typename T, int BS>
__global__ void padded_factor_sweep_kernel(const int* __restrict__ ptr,
                                           const int* __restrict__ pl,
                                           const int* __restrict__ pu,
                                           const int* __restrict__ dtab,
                                           const T* __restrict__ base,
                                           const T* __restrict__ ilu,
                                           const T* __restrict__ dsrc,
                                           T* __restrict__ out,
                                           long long nnz) {
  constexpr int B2 = BS * BS;
  const Lane<BS> L;
  if (!L.used) return;
  for (long long g = L.warp; g * L.kRows < nnz; g += L.nwarps) {
    const long long e = g * L.kRows + L.sub;
    if (e >= nnz) continue;
    const int p0 = ptr[e], p1 = ptr[e + 1];
    T acc[BS];
#pragma unroll
    for (int k = 0; k < BS; ++k) acc[k] = T(0);
    for (int p = p0; p < p1; ++p) {
      const T* __restrict__ a = ilu + (long long)pl[p] * B2 + L.i * BS;
      const T* __restrict__ b = ilu + (long long)pu[p] * B2;
      T ar[BS];
#pragma unroll
      for (int j = 0; j < BS; ++j) ar[j] = a[j];
#pragma unroll
      for (int k = 0; k < BS; ++k) {
        T c = ar[0] * b[k];
#pragma unroll
        for (int j = 1; j < BS; ++j) c = c + ar[j] * b[j * BS + k];
        acc[k] = (p == p0) ? c : acc[k] + c;
      }
    }
    const T* __restrict__ be = base + e * B2 + L.i * BS;
    T s[BS];
#pragma unroll
    for (int k = 0; k < BS; ++k) s[k] = (p1 > p0) ? be[k] - acc[k] : be[k];
    T* __restrict__ oe = out + e * B2 + L.i * BS;
    const int d = dtab[e];
    if (d < 0) {
#pragma unroll
      for (int k = 0; k < BS; ++k) oe[k] = s[k];
    } else if (BS == 1) {
      oe[0] = s[0] / dsrc[d];
    } else {
      const T* __restrict__ D = dsrc + (long long)d * B2;
#pragma unroll
      for (int k = 0; k < BS; ++k) {
        T v = s[0] * D[k];
#pragma unroll
        for (int j = 1; j < BS; ++j) v = v + s[j] * D[j * BS + k];
        oe[k] = v;
      }
    }
  }
}

// Call f with std::integral_constant<int, bs> for bs in 1..8; false for any
// other block size.
template <typename F>
bool with_block_size(int bs, F&& f) {
  switch (bs) {
    case 1: f(std::integral_constant<int, 1>{}); return true;
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

// mode: 0 = K9, 1 = K10 lower, 2 = K10 upper
template <typename T>
int padded_mv(int bs, int mode, const void* vals, const int* col,
              const void* x, const void* rhs, const void* dinv, void* out,
              long long n, int width, cudaStream_t s) {
  const bool ok = with_block_size(bs, [&](auto B) {
    constexpr int BS = decltype(B)::value;
    const dim3 grid = grid_for(n, 32 / BS);
    const T* v = (const T*)vals;
    if (mode == 0)
      padded_spmv_kernel<T, BS><<<grid, kThreads, 0, s>>>(
          v, col, (const T*)x, (T*)out, n, width);
    else if (mode == 1)
      padded_sweep_kernel<T, BS, false><<<grid, kThreads, 0, s>>>(
          v, col, nullptr, (const T*)rhs, (const T*)x, (T*)out, n, width);
    else
      padded_sweep_kernel<T, BS, true><<<grid, kThreads, 0, s>>>(
          v, col, (const T*)dinv, (const T*)rhs, (const T*)x, (T*)out, n,
          width);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

template <typename T>
int factor_sweep(int bs, const int* ptr, const int* pl, const int* pu,
                 const int* dtab, const void* base, const void* ilu,
                 const void* dsrc, void* out, long long nnz, cudaStream_t s) {
  const bool ok = with_block_size(bs, [&](auto B) {
    constexpr int BS = decltype(B)::value;
    padded_factor_sweep_kernel<T, BS>
        <<<grid_for(nnz, 32 / BS), kThreads, 0, s>>>(
            ptr, pl, pu, dtab, (const T*)base, (const T*)ilu,
            (const T*)dsrc, (T*)out, nnz);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float64; bs in 1..8.  Every pointer is a device
// pointer.  Returns a cudaError_t as int (cudaErrorInvalidValue for an
// unsupported bs, dtype or mode, or an upper sweep without dinv).
extern "C" {

int bt_padded_mv(int bs, int dtype, int mode, const void* vals,
                 const int* col, const void* x, const void* rhs,
                 const void* dinv, void* out, long long n, int width,
                 void* stream) {
  if (mode < 0 || mode > 2 || width < 0 || (mode > 0 && rhs == nullptr) ||
      (mode == 2 && dinv == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return padded_mv<float>(bs, mode, vals, col, x, rhs, dinv, out, n, width,
                            s);
  if (dtype == 1)
    return padded_mv<double>(bs, mode, vals, col, x, rhs, dinv, out, n,
                             width, s);
  return (int)cudaErrorInvalidValue;
}

int bt_padded_factor_sweep(int bs, int dtype, const int* ptr, const int* pl,
                           const int* pu, const int* dtab, const void* base,
                           const void* ilu, const void* dsrc, void* out,
                           long long nnz, void* stream) {
  if (nnz <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return factor_sweep<float>(bs, ptr, pl, pu, dtab, base, ilu, dsrc, out,
                               nnz, s);
  if (dtype == 1)
    return factor_sweep<double>(bs, ptr, pl, pu, dtab, base, ilu, dsrc, out,
                                nnz, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
