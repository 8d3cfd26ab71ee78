// Blocked exponential / power cone projection: all (count, 3) blocks of a
// cone factor in one launch, a warp per block.
//
// Replaces what XLA fuses for the JAX package from
// totsu_tpu/solver/cone.py _proj_exp_blocks / _proj_pow_blocks (there is
// no Pallas kernel: XLA fuses each fixed-trip core into one kernel). In
// eager PyTorch each core is thousands of elementwise launches, and the
// host loop projects twice per iteration, so the host loop needs this
// kernel to stay at a few launches per iteration.
//
// Bound on the H100: latency, and at many lanes per block instruction
// dispatch. The work per block is a root finder on 24 or 48 bytes in and
// out whose evaluations depend on each other (each two exponentials, or
// three logarithms and two square roots); the operations of a factor of a
// few thousand blocks take well under a microsecond of the card's rate,
// so the time is the longest chain of dependent evaluations times one
// evaluation's latency, plus the launch. A thread per block runs the
// serial chain: up to 40 + 38 trips (exp) or 54 (pow), and a warp waits
// for its slowest lane among blocks in different branches. Here the 32
// lanes of a warp share a block (cone_exppow.cuh's lane-parallel form at
// L = 32): the bracket expansion takes one round of 32 points instead of
// up to 40 trips, and each Newton trip also multisects the bracket 32
// times, so the chain is 7 to 14 evaluations on the smoke's test blocks.
// The price is dispatch: each block's warp runs a whole trip's
// instructions, and 2000 blocks are 2000 warps. On an NVIDIA H100 80GB
// HBM3 (700 W) 32 lanes were faster than 1, 8 and 16 on every input of
// cp_timing.py, the main path's largest factor (2000 blocks) included
// (PERF.md). The launch plan (ops/kernels/cone_proj.py plan) picks the
// CTA size that covers the SMs.
// The dual projection (the Moreau identity x + proj_K(-x)) is formed in
// the kernel, and the power exponent comes as a scalar or per block, so
// no negate, add or fill launches surround it.

#include <cuda_runtime.h>

#include "cone_exppow.cuh"

namespace {

// lanes per block: a warp
constexpr int kLanes = 32;

template <typename T>
__global__ void cone_proj_kernel(const T* __restrict__ in, T* __restrict__ out,
                                 const T* __restrict__ alpha, T alpha0,
                                 int count, int kind, int dual) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = tid / kLanes;  // the warp's block
  if (i >= count) return;
  const totsu_cone::Group<kLanes> g(threadIdx.x & 31);
  T v0 = in[3 * i], v1 = in[3 * i + 1], v2 = in[3 * i + 2];
  const T a = alpha != nullptr ? alpha[i] : alpha0;
  totsu_cone::proj_block<T, kLanes>(g, v0, v1, v2, kind, a, dual != 0);
  if (g.lane == 0) {
    out[3 * i] = v0;
    out[3 * i + 1] = v1;
    out[3 * i + 2] = v2;
  }
}

template <typename T>
int launch(const T* in, T* out, const T* alpha, T alpha0, int count, int kind,
           int dual, int threads, int grid, void* stream) {
  if (count <= 0) return 0;
  // the plan's launch, checked: whole warps, a warp for every block
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || grid < 1 ||
      static_cast<long long>(grid) * threads <
          static_cast<long long>(count) * kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  cone_proj_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, alpha, alpha0, count, kind, dual);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void eval_clocks_kernel(int kind, int evals, long long* clocks,
                                   T* sink) {
  clocks[0] = totsu_cone::eval_chain_clocks<T>(kind, evals, sink);
}

}  // namespace

extern "C" {

// Project the (count, 3) row-major blocks of `in` into `out` (another
// buffer): kind 0 = exp cone, 1 = power cone with exponent alpha[i]
// (alpha0 for every block when alpha is null); dual != 0 projects onto
// the dual cone. A warp per block; threads per CTA and grid as the
// wrapper's plan gives them. Returns a cudaError_t.
int totsu_cone_proj_f32(const float* in, float* out, const float* alpha,
                        float alpha0, int count, int kind, int dual,
                        int threads, int grid, void* stream) {
  return launch<float>(in, out, alpha, alpha0, count, kind, dual, threads,
                       grid, stream);
}

int totsu_cone_proj_f64(const double* in, double* out, const double* alpha,
                        double alpha0, int count, int kind, int dual,
                        int threads, int grid, void* stream) {
  return launch<double>(in, out, alpha, alpha0, count, kind, dual, threads,
                        grid, stream);
}

// Clocks (clock64, the SM clock) of `evals` dependent root-function
// evaluations (kind 0: exp with its derivative, 1: pow) in one thread,
// into clocks[0]; f64 when dbl != 0. sink (8 bytes) keeps the chain's
// result. Returns a cudaError_t.
int totsu_cone_eval_clocks(int kind, int dbl, int evals, long long* clocks,
                           void* sink, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dbl != 0)
    eval_clocks_kernel<double><<<1, 1, 0, s>>>(kind, evals, clocks,
                                               static_cast<double*>(sink));
  else
    eval_clocks_kernel<float><<<1, 1, 0, s>>>(kind, evals, clocks,
                                              static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}

const char* totsu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
