// Blocked exponential / power cone projection: all (count, 3) blocks of a
// cone factor in one launch, one block per thread.
//
// Replaces what XLA fuses for the JAX package from
// totsu_tpu/solver/cone.py _proj_exp_blocks / _proj_pow_blocks (there is
// no Pallas kernel: XLA fuses each fixed-trip core into one kernel). In
// eager PyTorch each core is thousands of elementwise launches, and the
// host loop projects twice per iteration, so the host loop needs this
// kernel to stay at a few launches per iteration.
//
// Bound on the H100: latency. The work per block is a fixed-trip root
// finder (up to 40 + 38 trips of some 50 flops and two exponentials, or
// 54 trips with three logarithms and two square roots) on 24 or 48 bytes
// in and out; a factor of a few thousand blocks is a few thousand threads
// of dependent transcendental arithmetic, far from filling 132 SMs. The
// design keeps it to one launch: the dual projection (the Moreau identity
// x + proj_K(-x)) is formed in the kernel, and the power exponent comes
// as a scalar or per block, so no negate, add or fill launches surround
// it. The arithmetic is cone_exppow.cuh, shared with megakernel.cu.

#include <cuda_runtime.h>

#include "cone_exppow.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cone_proj_kernel(const T* __restrict__ in, T* __restrict__ out,
                 const T* __restrict__ alpha, T alpha0, int count, int kind,
                 int dual) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  T v0 = in[3 * i], v1 = in[3 * i + 1], v2 = in[3 * i + 2];
  const T a = alpha != nullptr ? alpha[i] : alpha0;
  totsu_cone::proj_block(v0, v1, v2, kind, a, dual != 0);
  out[3 * i] = v0;
  out[3 * i + 1] = v1;
  out[3 * i + 2] = v2;
}

template <typename T>
int launch(const T* in, T* out, const T* alpha, T alpha0, int count,
           int kind, int dual, void* stream) {
  if (count <= 0) return 0;
  const int grid = (count + kThreads - 1) / kThreads;
  cone_proj_kernel<T><<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      in, out, alpha, alpha0, count, kind, dual);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Project the (count, 3) row-major blocks of `in` into `out` (another
// buffer): kind 0 = exp cone, 1 = power cone with exponent alpha[i]
// (alpha0 for every block when alpha is null); dual != 0 projects onto
// the dual cone. Returns a cudaError_t.
int totsu_cone_proj_f32(const float* in, float* out, const float* alpha,
                        float alpha0, int count, int kind, int dual,
                        void* stream) {
  return launch<float>(in, out, alpha, alpha0, count, kind, dual, stream);
}

int totsu_cone_proj_f64(const double* in, double* out, const double* alpha,
                        double alpha0, int count, int kind, int dual,
                        void* stream) {
  return launch<double>(in, out, alpha, alpha0, count, kind, dual, stream);
}

const char* totsu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
