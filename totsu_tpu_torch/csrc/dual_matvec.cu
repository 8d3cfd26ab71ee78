// Fused dual matvec: p = A u and q = A^T v from one read of A.
//
// Replaces the Pallas kernel totsu_tpu/ops/pallas/dual_matvec.py
// (dual_matvec_f32, body _kernel): a sequential grid over 256-row tiles
// that carries q from one step to the next. Every pdhg update calls it
// twice and every termination check once.
//
// Bound on the H100: bytes. Each element of A is read once (4 bytes in
// f32, 2 in bf16, 8 in f64) and used for two multiply-adds, far below the
// card's operations-per-byte line; the vectors and the partial sums are a
// few percent of A. So the kernel is a stream over A, and the design is
// about keeping that stream full on all 132 SMs. The first design lost to
// two cuBLAS GEMVs for three reasons, and this one answers each:
//
//  * Too few CTAs (one per 32-row tile: 125 at 4000 rows, less than one
//    per SM; 220 at 7040 rows, 1.67 waves). Now the wrapper's plan
//    (ops/kernels/dual_matvec.py, `plan`) cuts A from the SM count into
//    row groups x column chunks, about one CTA per SM in one wave: a
//    column chunk is at most 512 loads wide (one thread per load), row
//    groups are balanced to one row and hold 8 to 128 rows. Each CTA
//    streams a contiguous block of rows.
//  * Narrow loads (4 bytes a thread, a row test inside the unrolled
//    loop). Now a thread owns one 16-byte vector of columns (4 f32, 8
//    bf16, 2 f64) and walks the CTA's rows with 8 rows of loads in flight
//    while it sums the 8 before, with no row test in the unrolled body.
//    When n is not a multiple of the vector width (rows start unaligned)
//    or A's base is not 16-byte aligned, the same code runs with one
//    element per load.
//  * A second, serial launch for q (4 to 12 CTAs summing up to 220 tile
//    partials each, from a buffer allocated on every call). Now q's
//    partials, one row per row group, are summed inside the same launch,
//    in a fixed order and without floating-point atomics: an integer
//    ticket per reduction group (about sqrt(G) row groups) elects the
//    group's last CTA, which sums its group's partials in index order; a
//    second ticket elects the last of those, which sums the groups' sums
//    in index order. The tickets order nothing numeric, so a repeated call
//    is bitwise equal. Each elected CTA sets its counter back to 0, so the
//    counters are ready for the next launch (also inside a CUDA graph).
//    With more than one column chunk, the group's last CTA also sums the
//    chunks' partials of p for the group's rows.
//
// p: each thread's dot products of 8 rows are summed across the warp by a
// transposing butterfly (9 shuffles for 8 rows, not 40) into a table in
// shared memory, one row per warp, summed over the warps in warp order at
// the end. Scratch (the partials) and the counters come from the wrapper;
// the kernel allocates nothing.
//
// The first design took, on an H100 80GB HBM3 at 700 W, 26.0-26.1 us of
// device time per call at A 4000 x 1000 f32 against 14.1 us for two
// cuBLAS GEMVs, and 87.0 us at 7040 x 3040 against 58.3. This design's
// times are in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // threads (loads) per column chunk
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRows = 8;          // rows of loads in flight per thread
constexpr int kMaxRows = 128;     // rows of A per row group at most

// The launch plan (ops/kernels/dual_matvec.py `_PlanArgs`, same layout).
struct Plan {
  int m, n;
  int vec;         // elements of A per load: 16 / sizeof(T), or 1
  int nvec;        // loads per row of A: n / vec
  int threads;     // threads per CTA (>= chunk_vecs, a multiple of 32)
  int row_groups;  // G: CTA rows of the grid, balanced to one row of A
  int col_chunks;  // S: CTA columns of the grid
  int chunk_vecs;  // loads per row of a column chunk (the last may be short)
  int group_size;  // row groups per reduction group
  int groups;      // reduction groups: ceil(G / group_size)
};

// One load of A and its widening to the accumulation type.
template <typename T, int VEC> struct Vec;
template <> struct Vec<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&x)[4]) {
    x[0] = __uint_as_float(r.x); x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z); x[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  // a 32-bit word holds two bf16, the first in its low half; a bf16 widens
  // to the f32 with the same bits in the high half
  static __device__ __forceinline__ void unpack(const uint4& r, float (&x)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Vec<double, 2> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const uint4& r, double (&x)[2]) {
    x[0] = __hiloint2double(static_cast<int>(r.y), static_cast<int>(r.x));
    x[1] = __hiloint2double(static_cast<int>(r.w), static_cast<int>(r.z));
  }
};
template <typename T> struct Vec<T, 1> {
  using Raw = T;
  template <typename Acc>
  static __device__ __forceinline__ void unpack(const T& r, Acc (&x)[1]) {
    x[0] = static_cast<Acc>(r);
  }
};
template <> struct Vec<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ void unpack(const __nv_bfloat16& r,
                                                float (&x)[1]) {
    x[0] = __bfloat162float(r);
  }
};

// Sums R per-lane values (one per row) over the warp. Each butterfly step
// halves the rows a lane holds: a lane keeps one half and sends the other
// to its partner. Lane L ends with row L / (32 / R), summed over the warp,
// in a fixed order.
template <int R, typename Acc>
__device__ __forceinline__ Acc warp_rows(Acc (&x)[R], int lane) {
  int off = 16;
#pragma unroll
  for (int half = R / 2; half >= 1; half /= 2, off /= 2) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const Acc send = upper ? x[k] : x[k + half];
      const Acc keep = upper ? x[k + half] : x[k];
      x[k] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
#pragma unroll
  for (; off > 0; off /= 2) x[0] += __shfl_xor_sync(0xffffffffu, x[0], off);
  return x[0];
}

// 16 bytes of accumulators, for the cross-CTA sums
template <typename Acc> struct Pack;
template <> struct Pack<float> {
  using type = float4;
  static __device__ __forceinline__ void add(float4& s, const float4& x) {
    s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
  }
};
template <> struct Pack<double> {
  using type = double2;
  static __device__ __forceinline__ void add(double2& s, const double2& x) {
    s.x += x.x; s.y += x.y;
  }
};
template <typename Acc> struct Scalar {
  using type = Acc;
  static __device__ __forceinline__ void add(Acc& s, const Acc& x) { s += x; }
};

// out[j] = src[j] + src[stride + j] + ... + src[(cnt - 1) * stride + j]
// for j < len, in that order, by all threads of the CTA; kBurst loads in
// flight per thread. P is Pack<Acc> (16-byte loads: len, stride and the
// pointers in whole packs) or Scalar<Acc>. src was written by other CTAs
// of this launch: read through L2 (ld.cg), not the non-coherent L1.
template <typename P>
__device__ __forceinline__ void sum_rows(const typename P::type* src,
                                         size_t stride, int cnt, int len,
                                         typename P::type* out) {
  using E = typename P::type;
  constexpr int kBurst = 8;
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    E sum = __ldcg(src + j);
    for (int i0 = 1; i0 < cnt; i0 += kBurst) {
      E x[kBurst];
#pragma unroll
      for (int i = 0; i < kBurst; ++i)
        if (i0 + i < cnt) x[i] = __ldcg(src + (i0 + i) * stride + j);
#pragma unroll
      for (int i = 0; i < kBurst; ++i)
        if (i0 + i < cnt) P::add(sum, x[i]);
    }
    out[j] = sum;
  }
}

// q (n values) from cnt rows of partials: 16-byte loads when n allows
template <typename Acc>
__device__ __forceinline__ void sum_q(const Acc* src, int cnt, int n,
                                      Acc* out) {
  constexpr int kLanes = 16 / sizeof(Acc);
  if (n % kLanes == 0)
    sum_rows<Pack<Acc>>(
        reinterpret_cast<const typename Pack<Acc>::type*>(src), n / kLanes,
        cnt, n / kLanes, reinterpret_cast<typename Pack<Acc>::type*>(out));
  else
    sum_rows<Scalar<Acc>>(src, n, cnt, n, out);
}

__device__ __forceinline__ int row_start(int g, const Plan& pl) {
  return static_cast<int>(static_cast<long long>(g) * pl.m / pl.row_groups);
}

// Loads rows r, r+1, ..., r + kRows - 1 of the CTA's rows (A at ap, v at
// vs): this thread's load of A in each, and v. In the last, short batch a
// row past the end reads the last row again with v = 0, so all kRows
// loads stay in flight and the row adds nothing to q.
template <typename Raw, typename Acc>
__device__ __forceinline__ void load_rows(Raw (&buf)[kRows],
                                          Acc (&vb)[kRows], const Raw* ap,
                                          int nvec, const Acc* vs, int r,
                                          int rows) {
  if (r + kRows <= rows) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      buf[i] = __ldg(ap + static_cast<size_t>(r + i) * nvec);
      vb[i] = __ldg(vs + r + i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      buf[i] = __ldg(ap + static_cast<size_t>(min(r + i, rows - 1)) * nvec);
      vb[i] = r + i < rows ? __ldg(vs + r + i) : Acc(0);
    }
  }
}

// Adds this thread's columns of kRows loaded rows to q and the warp's sum
// of each row's dot product with u to red_w (the warp's row of the CTA's
// table), for the rows before ``rows``.
template <typename T, typename Acc, int VEC>
__device__ __forceinline__ void use_rows(
    const typename Vec<T, VEC>::Raw (&buf)[kRows], const Acc (&vb)[kRows],
    int r, int rows, const Acc (&uu)[VEC], Acc (&qa)[VEC], Acc* red_w,
    int lane) {
  Acc pr[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    Acc x[VEC];
    Vec<T, VEC>::unpack(buf[i], x);
    Acc acc = Acc(0);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      acc += x[k] * uu[k];
      qa[k] += x[k] * vb[i];
    }
    pr[i] = acc;
  }
  // after warp_rows, lane L holds row L / (32 / kRows) of the batch
  const Acc sum = warp_rows<kRows>(pr, lane);
  const int row = r + lane / (32 / kRows);
  if ((lane & (32 / kRows - 1)) == 0 && row < rows) red_w[row] = sum;
}

template <typename T, typename Acc, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
dual_matvec_kernel(const T* __restrict__ a, const Acc* __restrict__ u,
                   const Acc* __restrict__ v, Acc* p, Acc* q, Acc* scratch,
                   unsigned* counters, const Plan pl) {
  using V = Vec<T, VEC>;
  using Raw = typename V::Raw;
  __shared__ Acc red[kMaxWarps][kMaxRows];
  __shared__ unsigned ticket;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = blockIdx.x / pl.col_chunks;
  const int s = blockIdx.x % pl.col_chunks;
  const int r0 = row_start(g, pl);
  const int r1 = row_start(g + 1, pl);
  const size_t m = pl.m, n = pl.n;
  // scratch: q's partials per row group (G > 1), the groups' sums (more
  // than one group), p's partials per column chunk (S > 1)
  Acc* q_part = scratch;
  Acc* q_grp = q_part + (pl.row_groups > 1 ? pl.row_groups * n : 0);
  Acc* p_part = q_grp + (pl.groups > 1 ? pl.groups * n : 0);

  // this thread's load of each row; a thread past the chunk's edge reads
  // the chunk's last load again with u = 0: it adds nothing to p, and its
  // q is not stored
  const int cv_end = min(pl.nvec, (s + 1) * pl.chunk_vecs);
  const int cv_own = s * pl.chunk_vecs + tid;
  const bool active = cv_own < cv_end;
  const int cv = active ? cv_own : cv_end - 1;
  const size_t col = static_cast<size_t>(cv) * VEC;
  Acc uu[VEC], qa[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    uu[k] = active ? u[col + k] : Acc(0);
    qa[k] = Acc(0);
  }
  const Raw* ap = reinterpret_cast<const Raw*>(a)
                  + static_cast<size_t>(r0) * pl.nvec + cv;
  Acc* p_out = pl.col_chunks == 1 ? p : p_part + s * m;

  // the CTA's rows in batches of kRows, the next batch's loads in flight
  // while this one is summed
  const int rows = r1 - r0;
  const Acc* vs = v + r0;
  Raw b0[kRows], b1[kRows];
  Acc v0[kRows], v1[kRows];
  load_rows(b0, v0, ap, pl.nvec, vs, 0, rows);
  for (int r = 0;;) {
    if (r + kRows < rows) load_rows(b1, v1, ap, pl.nvec, vs, r + kRows, rows);
    use_rows<T, Acc, VEC>(b0, v0, r, rows, uu, qa, red[warp], lane);
    if ((r += kRows) >= rows) break;
    if (r + kRows < rows) load_rows(b0, v0, ap, pl.nvec, vs, r + kRows, rows);
    use_rows<T, Acc, VEC>(b1, v1, r, rows, uu, qa, red[warp], lane);
    if ((r += kRows) >= rows) break;
  }
  __syncthreads();
  for (int i = tid; i < rows; i += blockDim.x) {
    Acc sum = red[0][i];
    for (int w = 1; w < nwarps; ++w) sum += red[w][i];
    p_out[r0 + i] = sum;
  }
  if (active) {
    Acc* q_out = pl.row_groups == 1 ? q : q_part + g * n;
#pragma unroll
    for (int k = 0; k < VEC; ++k) q_out[col + k] = qa[k];
  }
  if (gridDim.x == 1) return;

  // ---- the cross-CTA sums: the last CTA of each reduction group
  __threadfence();
  __syncthreads();
  const int k = g / pl.group_size;
  const int g0 = k * pl.group_size;
  const int g1 = min(pl.row_groups, g0 + pl.group_size);
  if (tid == 0) ticket = atomicAdd(counters + k, 1u);
  __syncthreads();
  if (ticket != static_cast<unsigned>((g1 - g0) * pl.col_chunks - 1)) return;
  if (tid == 0) counters[k] = 0u;
  if (pl.row_groups > 1)
    sum_q(q_part + g0 * n, g1 - g0, pl.n, pl.groups == 1 ? q : q_grp + k * n);
  if (pl.col_chunks > 1) {
    const int i0 = row_start(g0, pl);
    sum_rows<Scalar<Acc>>(p_part + i0, m, pl.col_chunks,
                          row_start(g1, pl) - i0, p + i0);
  }
  if (pl.groups == 1) return;

  // ---- the last group: the groups' sums of q
  __threadfence();
  __syncthreads();
  if (tid == 0) ticket = atomicAdd(counters + pl.groups, 1u);
  __syncthreads();
  if (ticket != static_cast<unsigned>(pl.groups - 1)) return;
  if (tid == 0) counters[pl.groups] = 0u;
  sum_q(q_grp, pl.groups, pl.n, q);
}

template <typename T, typename Acc>
int launch(const void* a, const void* u, const void* v, void* p, void* q,
           void* scratch, void* counters, const Plan* pl, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool ok =
      pl->m > 0 && pl->n > 0 && pl->threads % 32 == 0 &&
      pl->threads <= kMaxThreads && pl->chunk_vecs <= pl->threads &&
      pl->row_groups >= 1 && pl->row_groups <= pl->m &&
      (pl->m + pl->row_groups - 1) / pl->row_groups <= kMaxRows &&
      pl->col_chunks >= 1 && pl->col_chunks * pl->chunk_vecs >= pl->nvec &&
      pl->group_size >= 1 &&
      pl->groups == (pl->row_groups + pl->group_size - 1) / pl->group_size &&
      (pl->vec == 1 ? pl->nvec == pl->n
                    : pl->vec == kVec && pl->n % kVec == 0 &&
                      pl->nvec == pl->n / kVec &&
                      reinterpret_cast<uintptr_t>(a) % 16 == 0);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(pl->row_groups * pl->col_chunks);
  const T* at = static_cast<const T*>(a);
  const Acc* ut = static_cast<const Acc*>(u);
  const Acc* vt = static_cast<const Acc*>(v);
  Acc* pt = static_cast<Acc*>(p);
  Acc* qt = static_cast<Acc*>(q);
  Acc* st = static_cast<Acc*>(scratch);
  unsigned* ct = static_cast<unsigned*>(counters);
  if (pl->vec == 1)
    dual_matvec_kernel<T, Acc, 1><<<grid, pl->threads, 0, s>>>(
        at, ut, vt, pt, qt, st, ct, *pl);
  else
    dual_matvec_kernel<T, Acc, kVec><<<grid, pl->threads, 0, s>>>(
        at, ut, vt, pt, qt, st, ct, *pl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int totsu_dual_matvec_plan_size() { return sizeof(Plan); }

int totsu_dual_matvec_max_threads() { return kMaxThreads; }

int totsu_dual_matvec_max_rows() { return kMaxRows; }

int totsu_dual_matvec_f32(const void* a, const void* u, const void* v,
                          void* p, void* q, void* scratch, void* counters,
                          const void* plan, void* stream) {
  return launch<float, float>(a, u, v, p, q, scratch, counters,
                              static_cast<const Plan*>(plan), stream);
}

int totsu_dual_matvec_bf16(const void* a, const void* u, const void* v,
                           void* p, void* q, void* scratch, void* counters,
                           const void* plan, void* stream) {
  return launch<__nv_bfloat16, float>(a, u, v, p, q, scratch, counters,
                                      static_cast<const Plan*>(plan), stream);
}

int totsu_dual_matvec_f64(const void* a, const void* u, const void* v,
                          void* p, void* q, void* scratch, void* counters,
                          const void* plan, void* stream) {
  return launch<double, double>(a, u, v, p, q, scratch, counters,
                                static_cast<const Plan*>(plan), stream);
}

const char* totsu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
