// Fused dual matvec: p = A u and q = A^T v from one read of A.
//
// Replaces the Pallas kernel totsu_tpu/ops/pallas/dual_matvec.py
// (dual_matvec_f32, body _kernel). Every pdhg update calls it twice and
// every termination check once.
//
// Bound on the H100: bytes. Each element of A is read once and used for
// two multiply-adds, so the kernel is a stream over A (4 bytes per element
// in f32, 2 in bf16, 8 in f64) far below the card's operations-per-byte
// line. The design reads A exactly once and keeps everything else small:
//
//  * dual_matvec_tile: one CTA per tile of kRows rows. Its threads walk
//    the columns with coalesced loads (thread t reads columns t, t+256,
//    ...), so each warp reads contiguous runs of a row. Every thread keeps
//    kRows partial dot products for p in registers and one partial of q
//    for its column; p_i is finished by a warp-shuffle + shared-memory
//    block reduction, and the tile's partial of q goes to q_part[tile, :].
//  * sum_tiles: a second small kernel sums q_part over the tiles in a
//    fixed order. No atomics: the summation order, and so the result, is
//    the same on every run (exact repeat solves depend on it).
//
// A may be stored as f32, bf16 (widened to f32 in registers, f32
// accumulation, as the TPU kernel does) or f64 (f64 accumulation). Ragged
// m and n are handled by masks; there is no padding copy.
//
// Measured on an H100 80GB HBM3 (700 W power limit), A 4000 x 1000 f32:
// 26 us of device time per call, against 14 us for two cuBLAS GEMVs on the
// same L2-resident A; 125 CTAs of 256 threads underfill the card
// (PERF.md). Simple and exact first; occupancy is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;      // rows of A per CTA
constexpr int kThreads = 256;  // threads per CTA of dual_matvec_tile
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ double widen(double x) { return x; }

template <typename T, typename Acc>
__global__ void __launch_bounds__(kThreads)
dual_matvec_tile(const T* __restrict__ a, const Acc* __restrict__ u,
                 const Acc* __restrict__ v, Acc* __restrict__ p,
                 Acc* __restrict__ q_part, int m, int n) {
  __shared__ Acc v_tile[kRows];
  __shared__ Acc red[kWarps][kRows];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, m - row0);
  if (tid < kRows) v_tile[tid] = tid < rows ? v[row0 + tid] : Acc(0);
  __syncthreads();

  Acc acc_p[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc_p[r] = Acc(0);

  const T* a_tile = a + static_cast<size_t>(row0) * n;
  Acc* q_out = q_part + static_cast<size_t>(blockIdx.x) * n;
  for (int j = tid; j < n; j += kThreads) {
    const Acc uj = u[j];
    Acc acc_q = Acc(0);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const Acc aij = widen(a_tile[static_cast<size_t>(r) * n + j]);
        acc_p[r] += aij * uj;
        acc_q += aij * v_tile[r];
      }
    }
    q_out[j] = acc_q;
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    Acc x = acc_p[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp][r] = x;
  }
  __syncthreads();
  if (tid < rows) {
    Acc s = Acc(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    p[row0 + tid] = s;
  }
}

template <typename Acc>
__global__ void sum_tiles(const Acc* __restrict__ q_part,
                          Acc* __restrict__ q, int tiles, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Acc s = Acc(0);
  for (int t = 0; t < tiles; ++t) s += q_part[static_cast<size_t>(t) * n + j];
  q[j] = s;
}

template <typename T, typename Acc>
int launch(const void* a, const void* u, const void* v, void* p, void* q,
           void* q_part, int m, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (m + kRows - 1) / kRows;
  dual_matvec_tile<T, Acc><<<tiles, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const Acc*>(u),
      static_cast<const Acc*>(v), static_cast<Acc*>(p),
      static_cast<Acc*>(q_part), m, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_tiles<Acc><<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const Acc*>(q_part), static_cast<Acc*>(q), tiles, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows of A per tile: q_part must hold ceil(m / totsu_dual_matvec_rows())
// rows of n accumulator values.
int totsu_dual_matvec_rows() { return kRows; }

int totsu_dual_matvec_f32(const void* a, const void* u, const void* v,
                          void* p, void* q, void* q_part, int m, int n,
                          void* stream) {
  return launch<float, float>(a, u, v, p, q, q_part, m, n, stream);
}

int totsu_dual_matvec_bf16(const void* a, const void* u, const void* v,
                           void* p, void* q, void* q_part, int m, int n,
                           void* stream) {
  return launch<__nv_bfloat16, float>(a, u, v, p, q, q_part, m, n, stream);
}

int totsu_dual_matvec_f64(const void* a, const void* u, const void* v,
                          void* p, void* q, void* q_part, int m, int n,
                          void* stream) {
  return launch<double, double>(a, u, v, p, q, q_part, m, n, stream);
}

const char* totsu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
