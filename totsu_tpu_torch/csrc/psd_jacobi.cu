// Kernel J: the PSD-cone projection of packed symmetric blocks by
// parallel-order cyclic Jacobi, all blocks of a cone factor in one launch,
// one CTA per block matrix.
//
// Replaces what XLA fuses for the JAX package from totsu_tpu/ops/jacobi.py
// jacobi_eigh (:102) and psd_part_jacobi (:151), reached through
// sympack.proj_psd_packed(method='jacobi') (there is no Pallas kernel: XLA
// compiles the 10-14 sweeps of k-1 rounds into one program). Eager PyTorch
// would launch about 40 operations per round (ops/jacobi.py _round): some
// 2,800 launches per projection at k = 8 and 18,800 at k = 48, so on the
// card the projection is this one launch.
//
// What it computes, step for step as ops/jacobi.py (its plain version):
// unpack the scaled-vec input (off-diagonals over sqrt2), pad an odd order
// with one decoupled zero row and column, set V = I, then run `sweeps`
// sweeps of kp-1 rounds of the round-robin schedule. In a round every row
// pair (i, j), i < j, gets the symmetric Schur rotation: theta = (a_jj -
// a_ii) / (2 a_ij), t = sign(theta) / (|theta| + sqrt(theta^2 + 1)), t = 1
// at theta = 0 (the antisymmetric tie-break: row j takes -1), c =
// rsqrt(t^2 + 1), s = t c for row i and -s for row j, and c = 1, s = 0 at
// an exactly zero pivot. A <- J^T A J is a 2 x 2 update of each pair of
// pairs P <= Q (on P == Q, the pair's own block, three distinct entries);
// V <- V J mixes two columns. Last, the eigenvalues w = diag(A) are
// clipped at 0, the columns of V scaled by sqrt(max(w, 0)) (U), and U U^T
// = V diag(max(w, 0)) V^T is written back packed and scaled
// (off-diagonals times sqrt2).
//
// Exact symmetry carries the algorithm: row j's rotation must be row i's
// with s negated, which holds only if a_ij == a_ji bit for bit. A is kept
// as its packed upper triangle, so there is one copy of each entry and
// symmetry is exact by construction (the plain version averages A2 with
// its transpose instead), and each pair's c and s are computed once and
// stored for both rows.
//
// Memory: A packed, kp(kp+1)/2 values, and V (stored transposed, V^T, so
// that the column update reads contiguous rows), kp^2 values, stay in
// shared memory while they fit the 227 KB a block may use (A and V up to
// about k = 194 in f32 and k = 138 in f64); above that V, and then A too,
// live in a global scratch that the wrapper allocates (one slice per CTA,
// read through L1 and L2) with the same code (ops/kernels/psd_jacobi.py
// plan). Two barriers per round: one after the rotation parameters, one
// after the update.
//
// Bound on the H100: the card's work is operations, about 6 kp^2 per
// round and 2 k per output entry of the rebuild, against a few bytes in
// and out; but one CTA per block matrix uses one SM of 132 per block, so
// below 132 blocks most of the card idles, and each round waits on two
// barriers and on shared-memory (or, above the fit, L2) latency. Making it
// fast (a warp per small block, several blocks per CTA, a better layout
// for k >= 128) is later work; this kernel is the simple one that is
// right.

#include <cuda_runtime.h>

namespace {

// threads per CTA at most (the plan picks up to this)
constexpr int kMaxThreads = 512;

__device__ __forceinline__ int tri(int c) { return c * (c + 1) / 2; }

// packed index of element (i, j) of a symmetric matrix, either order
__device__ __forceinline__ int pidx(int i, int j) {
  return i <= j ? tri(j) + i : tri(i) + j;
}

// row r <= column c of packed index p (column-major upper triangle)
__device__ __forceinline__ void unpack_index(int p, int& r, int& c) {
  int q = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while (tri(q) > p) --q;
  while (tri(q + 1) <= p) ++q;
  c = q;
  r = p - tri(q);
}

// the player at position `pos` in round `round` of the round-robin
// tournament over kp players (ops/jacobi.py _schedule): position 0 keeps
// player 0, the others rotate one place right per round; position p plays
// position kp-1-p
__device__ __forceinline__ int player(int pos, int round, int kp) {
  if (pos == 0) return 0;
  const int n = kp - 1;
  return 1 + ((pos - 1 - round) % n + n) % n;
}

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// A2 = J^T A J on the 2 x 2 block of rows (r1, r2) and columns (k1, k2),
// partners of each other: x_ij = A[r_i, k_j]; the plain version's order
// (B = A J first, then J^T B)
template <typename T>
__device__ __forceinline__ void rotate_block(T x11, T x12, T x21, T x22,
                                             T cr1, T sr1, T cr2, T sr2,
                                             T ck1, T sk1, T ck2, T sk2,
                                             T& y11, T& y12, T& y21,
                                             T& y22) {
  const T b11 = x11 * ck1 - x12 * sk1, b12 = x12 * ck2 - x11 * sk2;
  const T b21 = x21 * ck1 - x22 * sk1, b22 = x22 * ck2 - x21 * sk2;
  y11 = b11 * cr1 - b21 * sr1;
  y12 = b12 * cr1 - b22 * sr1;
  y21 = b21 * cr2 - b11 * sr2;
  y22 = b22 * cr2 - b12 * sr2;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    psd_jacobi_kernel(const T* __restrict__ in, T* __restrict__ out,
                      T* __restrict__ scratch, int k, int sweeps, int scaled,
                      int a_smem, int v_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kp = k + (k & 1);
  const int h = kp / 2;
  const int sn = tri(k);
  const int kpack = tri(kp);
  const long long blk = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;

  T* sp = reinterpret_cast<T*>(smem_raw);
  T* gs = scratch + blk * static_cast<long long>((a_smem ? 0 : kpack) +
                                                 (v_smem ? 0 : kp * kp));
  T* A;
  T* V;  // V^T: V[b * kp + i] is V(i, b)
  if (a_smem) { A = sp; sp += kpack; } else { A = gs; gs += kpack; }
  if (v_smem) { V = sp; sp += kp * kp; } else { V = gs; }
  T* cs = sp;       // c of each row in this round; then sqrt(max(w, 0))
  T* ss = sp + kp;  // s of each row in this round
  int* pa = reinterpret_cast<int*>(sp + 2 * kp);  // pair P = (pa, pb),
  int* pb = pa + h;                               // pa < pb

  const T inv_sqrt2 = static_cast<T>(0.70710678118654752440);
  const T sqrt2 = static_cast<T>(1.41421356237309504880);
  const T* x = in + blk * sn;
  for (int p = tid; p < kpack; p += nt) {
    T val = T(0);  // the padding column of an odd order
    if (p < sn) {
      int r, c;
      unpack_index(p, r, c);
      val = (scaled && r != c) ? x[p] * inv_sqrt2 : x[p];
    }
    A[p] = val;
  }
  for (int p = tid; p < kp * kp; p += nt)
    V[p] = (p / kp == p % kp) ? T(1) : T(0);
  __syncthreads();

  const int nblk = tri(h);  // pairs of pairs (P <= Q)
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int rd = 0; rd < kp - 1; ++rd) {
      // the rotation of each pair (i, j), i < j
      for (int P = tid; P < h; P += nt) {
        const int a = player(P, rd, kp), b = player(kp - 1 - P, rd, kp);
        const int i = min(a, b), j = max(a, b);
        pa[P] = i;
        pb[P] = j;
        const T aij = A[pidx(i, j)];
        T c = T(1), s = T(0);
        if (aij != T(0)) {  // an exactly zero pivot: the identity
          const T theta = (A[pidx(j, j)] - A[pidx(i, i)]) / (T(2) * aij);
          T t = T(1);  // equal diagonals: 45 degrees, +1 for the lower row
          if (theta != T(0))
            t = (theta > T(0) ? T(1) : T(-1)) /
                (fabs(theta) + sqrt(theta * theta + T(1)));
          c = rsqrt_t(t * t + T(1));
          s = t * c;
        }
        cs[i] = c;
        cs[j] = c;
        ss[i] = s;
        ss[j] = -s;
      }
      __syncthreads();
      // A <- J^T A J: the 2 x 2 block of rows P, columns Q, P <= Q, one
      // thread each; the packed triangle holds its mirror (Q, P) already.
      // On P == Q the block's off-diagonal entries are one (the pivot,
      // written from y12)
      for (int q = tid; q < nblk; q += nt) {
        int P, Q;
        unpack_index(q, P, Q);
        const int a = pa[P], a2 = pb[P], b = pa[Q], b2 = pb[Q];
        const int i11 = pidx(a, b), i12 = pidx(a, b2), i21 = pidx(a2, b),
                  i22 = pidx(a2, b2);
        const T x11 = A[i11], x12 = A[i12], x21 = A[i21], x22 = A[i22];
        T y11, y12, y21, y22;
        rotate_block(x11, x12, x21, x22, cs[a], ss[a], cs[a2], ss[a2],
                     cs[b], ss[b], cs[b2], ss[b2], y11, y12, y21, y22);
        A[i11] = y11;
        if (P != Q) A[i21] = y21;
        A[i12] = y12;
        A[i22] = y22;
      }
      // V <- V J: columns b and b2 of pair Q, row i
      for (int q = tid; q < h * kp; q += nt) {
        const int Q = q / kp, i = q % kp;
        const int b = pa[Q], b2 = pb[Q];
        const T v1 = V[b * kp + i], v2 = V[b2 * kp + i];
        V[b * kp + i] = v1 * cs[b] - v2 * ss[b];
        V[b2 * kp + i] = v2 * cs[b2] - v1 * ss[b2];
      }
      __syncthreads();
    }
  }

  // X+ = U U^T, U = V diag(sqrt(max(w, 0))), over the first k rows and
  // columns (the padding's eigenvector is e_kp with eigenvalue 0), packed
  // and scaled
  for (int j = tid; j < k; j += nt) cs[j] = sqrt(max(A[pidx(j, j)], T(0)));
  __syncthreads();
  for (int p = tid; p < k * k; p += nt) {
    const int j = p / k;
    V[j * kp + p % k] *= cs[j];
  }
  __syncthreads();
  T* y = out + blk * sn;
  for (int p = tid; p < sn; p += nt) {
    int r, c;
    unpack_index(p, r, c);
    T acc = T(0);
    for (int j = 0; j < k; ++j) acc += V[j * kp + r] * V[j * kp + c];
    y[p] = (scaled && r != c) ? acc * sqrt2 : acc;
  }
}

// dynamic shared memory of a launch: A (packed) and V^T where they are in
// shared memory, c and s of each row, the pairs' two rows
long long smem_bytes(int k, int a_smem, int v_smem, int elem) {
  const long long kp = k + (k & 1);
  return elem * ((a_smem ? kp * (kp + 1) / 2 : 0) + (v_smem ? kp * kp : 0) +
                 2 * kp) +
         static_cast<long long>(sizeof(int)) * kp;
}

template <typename T>
int launch(const T* in, T* out, T* scratch, int k, int count, int sweeps,
           int scaled, int threads, int a_smem, int v_smem, long long smem,
           void* stream) {
  if (count <= 0 || k <= 0) return 0;
  // the plan's launch, checked: whole warps, the layout's bytes, a scratch
  // where A or V is not in shared memory
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      sweeps < 0 || smem != smem_bytes(k, a_smem, v_smem, sizeof(T)) ||
      ((!a_smem || !v_smem) && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        psd_jacobi_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  psd_jacobi_kernel<T><<<count, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      in, out, scratch, k, sweeps, scaled, a_smem, v_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Project the (count, k(k+1)/2) row-major packed blocks of `in` onto the
// PSD cone into `out` (another buffer), scaled-vec convention when scaled
// != 0; `sweeps` Jacobi sweeps; a CTA of `threads` per block; A (packed)
// and V in shared memory where a_smem / v_smem, else in `scratch` (count
// slices of the plan's size); `smem` the plan's dynamic shared memory
// bytes. Returns a cudaError_t.
int totsu_psd_jacobi_f32(const float* in, float* out, float* scratch, int k,
                         int count, int sweeps, int scaled, int threads,
                         int a_smem, int v_smem, long long smem,
                         void* stream) {
  return launch<float>(in, out, scratch, k, count, sweeps, scaled, threads,
                       a_smem, v_smem, smem, stream);
}

int totsu_psd_jacobi_f64(const double* in, double* out, double* scratch,
                         int k, int count, int sweeps, int scaled,
                         int threads, int a_smem, int v_smem, long long smem,
                         void* stream) {
  return launch<double>(in, out, scratch, k, count, sweeps, scaled, threads,
                        a_smem, v_smem, smem, stream);
}

// The dynamic shared memory bytes of a layout (to check the wrapper's
// plan against the kernel's).
long long totsu_psd_jacobi_smem_bytes(int k, int a_smem, int v_smem,
                                      int elem) {
  return smem_bytes(k, a_smem, v_smem, elem);
}

// Shared memory a block may opt in to on the card (bytes), or -1.
int totsu_psd_jacobi_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

const char* totsu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
