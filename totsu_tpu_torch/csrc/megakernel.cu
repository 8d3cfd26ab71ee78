// Whole-solve pdhg megakernel: the entire iteration loop in one
// cooperative launch over many SMs.
//
// Replaces the Pallas kernel totsu_tpu/ops/pallas/megakernel.py
// (solve_mega, body built by _build_kernel) for the zero, R+, SOC, RSOC,
// exponential and power cones with accel '' or 'halpern', optional relax,
// check_at_start and the sb/sc unscaling of the criteria. Same algorithm
// as the host loop of totsu_tpu_torch/solver/conic.py; sums run in another
// order, so results agree to f32 reduction-order roundoff.
//
// Bound on the H100: latency. Each iteration is two fused matvec pairs
// (and one more on a check) whose inputs depend on the pair before, so the
// loop is a chain of short steps. The TPU kernel keeps A^T in VMEM for the
// whole solve and forms each pair from one read of it. The H100's
// counterpart of VMEM is shared memory, 227 KB on each of 132 SMs, so the
// design is:
//
//  * A launch plan in Python (ops/kernels/megakernel.py, `plan`) cuts the
//    rows of A into G contiguous slices, one CTA per slice and one CTA per
//    SM, cut only where no SOC/RSOC block or exp/pow 3-block is split. A
//    small A gets G = 1, where a grid barrier would cost more than it
//    saves. Each CTA loads its rows of A into shared memory once, at
//    launch; a slice that does not fit is read from global memory (L2) by
//    that CTA alone.
//  * One read of the rows per matvec pair: in one pass each CTA forms
//    p = A x for its rows (complete, local) and its partial of q = A^T y.
//    The m-side vectors (y, s, vm and the temporaries) live with the rows
//    that produce them, so the cone projections are local too. The n-side
//    vectors (x, vn, the Halpern anchor, the n-side temporaries) are
//    replicated in every CTA and updated identically.
//  * Cross-CTA sums without floating-point atomics: each CTA writes its
//    partial of q and its m-side partial sums (b.vm, the check's residual
//    norms, the Halpern fixed-point norm) to a row of a global buffer,
//    then a grid barrier, then the rows are summed in a fixed order. In the
//    replicated mode every CTA sums all rows (two buffer slots alternate,
//    so a fast CTA never overwrites a row a slow one still reads); in the
//    split mode CTA g sums a slice of the columns into one row, a second
//    barrier, then every CTA reads that row. Either way every CTA holds
//    the same bits, so every CTA takes the same branches (status, restart,
//    exit) and no CTA leaves the loop while another waits at a barrier. A
//    repeat solve is bitwise equal.
//  * The grid barrier is an arrival count in a word the wrapper zeroes per
//    call, released with a fence and acquired with ld.acquire; the launch
//    is cooperative (cudaLaunchCooperativeKernel), which refuses a grid
//    that cannot be resident all at once instead of deadlocking.
//  * A launch solves a batch of lanes (the Pallas kernel under jax.vmap):
//    lane l is the CTAs of blockIdx.y = l, each lane with its own data,
//    barrier word, partials and outputs, and A either per lane or one
//    matrix every lane reads. A lane's CTAs hold the same bits, so they
//    take the same branches; lanes exit on their own. The plan
//    (`plan_batch`) gives each lane G CTAs with lanes x G resident, or one
//    CTA per lane, which needs no barrier and so no residency.
//  * Reductions inside a CTA (dot products, norms, SOC block norms) are
//    warp-shuffle + shared-memory sums in a fixed order.
//  * SOC/RSOC blocks: a warp per block, the RSOC's involutive Givens map
//    on its first two slots; length-1 RSOC blocks are R+ elements. Exp
//    and pow 3-blocks: a thread per block running cone_exppow.cuh's
//    per-thread form behind a call that is not inlined, in a loop
//    instantiation (kTri) used only when the cone has such blocks: the
//    core adds live values and spills (PERF.md). Kernel B's lane-parallel
//    form, a group of lanes per block, was slower here on the H100: a CTA
//    holds a few dozen 3-blocks, and each group runs a whole trip per
//    block (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cone_exppow.cuh"

// Arguments of totsu_mega_solve, filled by ops/kernels/megakernel.py
// (_MegaArgs mirrors this layout; totsu_mega_struct_size checks it). At
// global scope: a type from the unnamed namespace would give the
// extern "C" entry point internal linkage.
//
// A launch solves `lanes` independent problems of one shape and one cone
// layout (a single solve is one lane). Every vector below holds the lanes
// one after another: an n-vector (lanes, n), an m-vector (lanes, m);
// scal_out (lanes, 7), int_out (lanes, 2), lane_scal (lanes, 8), barrier
// (lanes), partials and scratch one lane's share after another. A's lanes
// are m n floats apart, or every lane reads one A (a_shared).
struct MegaArgs {
  // problem data, f32 on the device; each lane's A is (m, n) row-major
  const float* a;
  const float* c_it;
  const float* b_it;
  const float* c_ex;
  const float* b_ex;
  const float* dptx;
  const float* dpty;
  const float* dpts;
  const float* dpsx;
  const float* dpsy;
  // seed
  const float* ux0;
  const float* uy0;
  const float* us0;
  const float* vn0;
  const float* vm0;
  // per-lane scalars: dp tau and sigma of tau, ||b||, ||c|| (exact data),
  // the seed's tau and kappa, the normalization's sb and sc
  const float* lane_scal;
  // cone metadata: per-element kind (m,), SOC/RSOC blocks (nb, 3) =
  // start, dim, rot; exp/pow 3-blocks (nt, 2) = start, kind (0 exp, 1
  // pow) and their power exponents (nt,). Block starts are relative to
  // the first row of the CTA that owns the block.
  const int* kind;
  const int* blocks;
  const int* tri;
  const float* tri_alpha;
  // outputs
  float* ux;
  float* uy;
  float* us;
  float* vn;
  float* vm;
  float* scal_out;  // ut, v1, cri_pri, cri_dual, cri_gap, cri_unbdd, cri_infeas
  int* int_out;     // k, status
  float* scratch;   // grid x ws_floats vector floats when not in shared memory
  // the launch plan: per CTA its first row, first SOC/RSOC block and first
  // 3-block (grid + 1 each), and whether its rows of A are held in shared
  // memory (grid)
  const int* row_off;
  const int* blk_off;
  const int* tri_off;
  const int* a_smem;
  float* partials;    // (2 grid + 1) rows of ld floats: the cross-CTA sums
  unsigned* barrier;  // each lane's grid barrier arrival count, zeroed
  int lanes, a_shared, m, n, nb, nt;
  int max_iter, check_period, halpern, check_at_start;
  int grid, rows_max, col_threads, split, vec_smem, a_floats, ws_floats, ld;
  float eps_acc, eps_inf, eps_zero, relax;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;  // most column steps per thread per pass block
constexpr int kBatch = 8;  // rows per transposing warp sum of the pass
constexpr int kScal = 4;   // m-side scalars summed over the grid with q

constexpr int kRunning = 0, kConverged = 1, kExcess = 2, kUnbounded = 3,
              kInfeasible = 4;
// per-element kinds projected elementwise; the others (2: SOC/RSOC, 3:
// exp, 4: pow) are projected block by block
constexpr int kKindZero = 0, kKindRpos = 1;
constexpr float kInvSqrt2 = 0.70710678118654752440f;

// vector workspace floats of a CTA (the wrapper's plan mirrors this)
__host__ __device__ constexpr long long workspace_floats(int n, int rows) {
  return 8LL * n + (11LL + kWarps) * rows + kThreads * kSteps;
}

// one iterate (u, v): x, vn (n, replicated), y, s, vm (the CTA's rows),
// and the scalars (ut, v1) in shared memory
struct Vecs {
  float* x;
  float* y;
  float* s;
  float* vn;
  float* vm;
  float* sc;
};

struct Work {
  float* p;   // (rows) the pass's A x
  float* q;   // (n) the pass's A^T y, summed over the grid
  float* rn;  // (n) temporary
  float* rm;  // (rows) temporary
};

// What one CTA owns, and the state of its cross-CTA sums.
struct Ctx {
  int cta, grid, rows, n;
  int cw, sets, steps;  // threads per row set of the pass, row sets, and
                        // column steps per block: min(kSteps, ceil(n / cw))
  const float* a;       // the CTA's rows of A (shared or global), stride n
  float* ptab;          // (rows, kWarps) per-warp partials of p
  float* qtab;          // (kThreads kSteps) per-row-set partials of q
  float* red;           // (4 kWarps) block_sum scratch
  float* sred;          // (kScal) the grid's scalar sums
  float* part;          // partials buffer (global)
  unsigned* bar;
  unsigned target;      // arrivals the next barrier waits for
  int nred, ld, split;  // sums done so far, floats per partials row, mode
  // the CTA's slices of the m-side data and cone tables
  const float *b_it, *b_ex, *dpty, *dpts, *dpsy;
  const int *kind, *blocks, *tri;
  const float* tri_alpha;
  int nb, nt;
  // the lane's n-side data and scalars
  const float *c_it, *c_ex, *dptx, *dpsx;
  float dptt, dpst, norm_b, norm_c, sb, sc;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;  // the total is in lane 0
}

// Sums R per-lane values (one per row) over the warp. Each butterfly step
// halves the rows a lane holds: a lane keeps one half and sends the other
// to its partner. Lane L ends with row L / (32 / R), summed over the warp,
// in a fixed order.
template <int R>
__device__ __forceinline__ float warp_rows(float (&x)[R], int lane) {
  int off = 16;
#pragma unroll
  for (int half = R / 2; half >= 1; half /= 2, off /= 2) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = upper ? x[k] : x[k + half];
      const float keep = upper ? x[k + half] : x[k];
      x[k] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
#pragma unroll
  for (; off > 0; off /= 2) x[0] += __shfl_xor_sync(0xffffffffu, x[0], off);
  return x[0];
}

// x summed over each aligned group of `width` lanes (a power of two up
// to 32) by a butterfly: every lane of the group gets the same bits (each
// step adds the same two values, in either order).
__device__ __forceinline__ float group_sum(float x, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sum each v[q] over the block; every thread gets the same totals.
template <int N>
__device__ void block_sum(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float x = warp_sum(v[q]);
    if (lane == 0) red[q * kWarps + warp] = x;
  }
  __syncthreads();
  // each warp sums the kWarps partials by a butterfly over its lanes
#pragma unroll
  for (int q = 0; q < N; ++q)
    v[q] = group_sum(red[q * kWarps + (lane % kWarps)], kWarps);
  __syncthreads();
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :
               : "l"(p), "r"(v)
               : "memory");
}

// Grid barrier over the lane's CTAs: every CTA's writes before it are
// visible to every CTA of the lane after it. Thread 0 arrives with a
// release (cumulative over the CTA's writes, which __syncthreads ordered
// before it) and waits with acquire loads. The count only grows (by G per barrier); the wrapped difference
// keeps the wait right past 2^32 arrivals.
__device__ void grid_sync(Ctx& cx) {
  __syncthreads();
  cx.target += static_cast<unsigned>(cx.grid);
  if (threadIdx.x == 0) {
    red_release(cx.bar, 1u);
    while (static_cast<int>(cx.target - ld_acquire(cx.bar)) > 0) {
    }
  }
  __syncthreads();
}

// Where the pass writes q: the CTA's row of the current buffer slot, or
// the local q when the grid is one CTA.
__device__ __forceinline__ float* q_out(const Ctx& cx, float* q) {
  if (cx.grid == 1) return q;
  const int slot = cx.split ? 0 : (cx.nred & 1);
  return cx.part + (static_cast<size_t>(slot) * cx.grid + cx.cta) * cx.ld;
}

// One read of the CTA's rows: p = A x (its rows) and qo = A^T y (its
// partial). Row set h = tid / cw takes rows h, h + sets, ...; within a row
// set a thread takes columns c, c + cw, ... (S of them per block of
// columns), keeps x and its q sums in registers, and the warp sums each
// batch of kBatch rows' dot products by a transposing butterfly into ptab.
template <int S>
__device__ void pass_steps(const Ctx& cx, const float* x, const float* y,
                           float* p, float* qo) {
  const int n = cx.n, rows = cx.rows, cw = cx.cw, sets = cx.sets;
  const int tid = threadIdx.x, lane = tid & 31;
  const int h = tid / cw, c = tid % cw, wc = c >> 5;
  for (int jb = 0; jb < n; jb += cw * S) {
    float xr[S], qa[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int j = jb + k * cw + c;
      xr[k] = j < n ? x[j] : 0.f;
      qa[k] = 0.f;
    }
    for (int b0 = h; b0 < rows; b0 += sets * kBatch) {
      float pr[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int i = b0 + r * sets;
        const float yi = i < rows ? y[i] : 0.f;
        const float* row = cx.a + static_cast<size_t>(i < rows ? i : 0) * n;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const int j = jb + k * cw + c;
          const float av = (i < rows && j < n) ? row[j] : 0.f;
          acc = fmaf(av, xr[k], acc);
          qa[k] = fmaf(av, yi, qa[k]);
        }
        pr[r] = acc;
      }
      // lane L holds row L / 4 of the batch
      const float sum = warp_rows<kBatch>(pr, lane);
      const int i = b0 + (lane >> 2) * sets;
      if ((lane & 3) == 0 && i < rows) {
        float* t = cx.ptab + i * kWarps + wc;
        *t = jb == 0 ? sum : *t + sum;
      }
    }
    if (sets == 1) {
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int j = jb + k * cw + c;
        if (j < n) qo[j] = qa[k];
      }
    } else {  // n <= cw S: one block of columns; the row sets' sums in order
      const int width = cw * S;
#pragma unroll
      for (int k = 0; k < S; ++k) cx.qtab[h * width + k * cw + c] = qa[k];
      __syncthreads();
      for (int j = tid; j < n; j += kThreads) {
        float s = cx.qtab[j];
        for (int g = 1; g < sets; ++g) s += cx.qtab[g * width + j];
        qo[j] = s;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  const int nwc = cw >> 5;
  for (int i = tid; i < rows; i += kThreads) {
    float s = cx.ptab[i * kWarps];
    for (int w = 1; w < nwc; ++w) s += cx.ptab[i * kWarps + w];
    p[i] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void pass(const Ctx& cx, const float* x,
                                     const float* y, float* p, float* qo) {
  if (cx.steps == 1)
    pass_steps<1>(cx, x, y, p, qo);
  else if (cx.steps == 2)
    pass_steps<2>(cx, x, y, p, qo);
  else
    pass_steps<kSteps>(cx, x, y, p, qo);
}

// Columns [j0, j1) of cnt rows of src (stride ld) summed over the rows;
// out(j, sum) takes each. src was written by other CTAs: read through L2.
// A group of `width` lanes takes a column (width: a power of two up to
// 32, as many as the threads allow), lane c the rows c, c + width, ...
// in order, then the group's butterfly: a fixed order, so a repeat gives
// the same bits.
template <typename Out>
__device__ __forceinline__ void sum_cols(const float* src, int ld, int cnt,
                                         int j0, int j1, Out out) {
  const int len = j1 - j0;
  int width = 1;
  while (width < 32 && width * 2 * len <= kThreads && width < cnt) width *= 2;
  const int per = kThreads / width, c = threadIdx.x % width;
  for (int base = 0; base < len; base += per) {
    const int j = j0 + base + threadIdx.x / width;
    float s = 0.f;
    if (j < j1) {
      for (int g0 = c; g0 < cnt; g0 += 8 * width) {
        float x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int g = g0 + i * width;
          x[i] = g < cnt ? __ldcg(src + static_cast<size_t>(g) * ld + j)
                         : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) s += x[i];
      }
    }
    s = group_sum(s, width);
    if (c == 0 && j < j1) out(j, s);
  }
}

// After a pass: sums the CTA's m-side partials s over the CTA, then q and
// s over the grid, in a fixed order. On return q (n) and s hold the grid's
// totals, the same bits in every CTA.
template <int NS>
__device__ void grid_sum(Ctx& cx, float* q, float (&s)[NS]) {
  block_sum<NS>(s, cx.red);
  if (cx.grid == 1) return;
  const int n = cx.n, tid = threadIdx.x, len = n + NS;
  const int slot = cx.split ? 0 : (cx.nred & 1);
  const float* rows = cx.part + static_cast<size_t>(slot) * cx.grid * cx.ld;
  if (tid == 0) {
    float* mine =
        const_cast<float*>(rows) + static_cast<size_t>(cx.cta) * cx.ld;
#pragma unroll
    for (int k = 0; k < NS; ++k) mine[n + k] = s[k];
  }
  grid_sync(cx);
  float* sred = cx.sred;
  const auto keep = [q, n, sred](int j, float v) {
    if (j < n) q[j] = v; else sred[j - n] = v;
  };
  if (cx.split) {
    float* sum = cx.part + static_cast<size_t>(2) * cx.grid * cx.ld;
    const int j0 = cx.cta * len / cx.grid;
    const int j1 = (cx.cta + 1) * len / cx.grid;
    sum_cols(rows, cx.ld, cx.grid, j0, j1,
             [sum](int j, float v) { sum[j] = v; });
    grid_sync(cx);
    for (int j = tid; j < len; j += kThreads) keep(j, __ldcg(sum + j));
  } else {
    sum_cols(rows, cx.ld, cx.grid, 0, len, keep);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NS; ++k) s[k] = cx.sred[k];
  ++cx.nred;
}

// Exp and pow 3-blocks of x onto their cones (or duals): a thread per
// block.
__device__ __noinline__ void project_tri(float* x, bool dual, const int* tri,
                                         const float* tri_alpha, int nt) {
  for (int bi = threadIdx.x; bi < nt; bi += kThreads) {
    float* xb = x + tri[2 * bi];
    float v0 = xb[0], v1 = xb[1], v2 = xb[2];
    totsu_cone::per_thread::proj_block<float>(v0, v1, v2, tri[2 * bi + 1],
                                              tri_alpha[bi], dual);
    xb[0] = v0;
    xb[1] = v1;
    xb[2] = v2;
  }
}

// In-place projection of the CTA's rows of an m-vector onto K (dual =
// false) or K*. The element kinds, the SOC blocks and the 3-blocks are
// disjoint, so their loops need no barrier between them; the caller's
// __syncthreads() ends them all. kTri: the cone has exp/pow 3-blocks.
template <bool kTri>
__device__ void project(float* x, bool dual, const Ctx& cx) {
  for (int i = threadIdx.x; i < cx.rows; i += kThreads) {
    const int k = cx.kind[i];
    if (k == kKindZero) {
      if (!dual) x[i] = 0.f;  // the zero cone's dual is everything
    } else if (k == kKindRpos) {
      x[i] = fmaxf(x[i], 0.f);
    }
  }
  // SOC (and rotated SOC) blocks are self-dual: a warp per block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int bi = warp; bi < cx.nb; bi += kWarps) {
    const int start = cx.blocks[3 * bi];
    const int dim = cx.blocks[3 * bi + 1];
    const bool rot = cx.blocks[3 * bi + 2] != 0;
    float* xb = x + start;
    float t, s1 = 0.f;
    if (rot) {
      const float x0 = xb[0], x1 = xb[1];
      t = (x0 + x1) * kInvSqrt2;
      s1 = (x0 - x1) * kInvSqrt2;
    } else {
      t = xb[0];
    }
    float ss = 0.f;
    for (int e = 1 + lane; e < dim; e += 32) {
      const float val = (rot && e == 1) ? s1 : xb[e];
      ss += val * val;
    }
    ss = __shfl_sync(0xffffffffu, warp_sum(ss), 0);
    const float nrm = sqrtf(ss);
    float head, cf;
    if (nrm <= t) {
      head = t;
      cf = 1.f;
    } else if (nrm <= -t) {
      head = 0.f;
      cf = 0.f;
    } else {
      head = 0.5f * (t + nrm);
      cf = head / nrm;
    }
    __syncwarp();
    for (int e = 1 + lane; e < dim; e += 32)
      if (!(rot && e == 1)) xb[e] *= cf;
    if (lane == 0) {
      if (rot) {
        const float s1n = s1 * cf;
        xb[0] = (head + s1n) * kInvSqrt2;
        xb[1] = (head - s1n) * kInvSqrt2;
      } else {
        xb[0] = head;
      }
    }
  }
  if constexpr (kTri) project_tri(x, dual, cx.tri, cx.tri_alpha, cx.nt);
}

// One Pock-Chambolle step t = T(z) (SolverCore::update_vecs).
template <bool kTri>
__device__ void update(const Vecs& z, const Vecs& t, const Work& w,
                       const MegaArgs& g, Ctx& cx) {
  const int n = cx.n, rows = cx.rows, tid = threadIdx.x;
  const float ut = z.sc[0], v1 = z.sc[1];
  // K^T v: A vn (the CTA's rows) and A^T vm (over the grid)
  pass(cx, z.vn, z.vm, w.p, q_out(cx, w.q));
  float d[1] = {0.f}, s[1] = {0.f};
  for (int j = tid; j < n; j += kThreads) d[0] += cx.c_it[j] * z.vn[j];
  for (int i = tid; i < rows; i += kThreads) s[0] += cx.b_it[i] * z.vm[i];
  grid_sum<1>(cx, w.q, s);
  block_sum<1>(d, cx.red);
  float ut_n = fmaxf(ut - cx.dptt * (d[0] + s[0]), 0.f);
  for (int j = tid; j < n; j += kThreads) {
    const float xn = z.x[j] - cx.dptx[j] * (-w.q[j] - cx.c_it[j] * v1);
    t.x[j] = xn;
    w.rn[j] = z.x[j] - 2.f * xn;
  }
  for (int i = tid; i < rows; i += kThreads) {
    t.y[i] = z.y[i] - cx.dpty[i] * (w.p[i] - cx.b_it[i] * v1);
    t.s[i] = z.s[i] - cx.dpts[i] * (-z.vm[i]);
  }
  __syncthreads();
  project<kTri>(t.y, true, cx);
  project<kTri>(t.s, false, cx);
  __syncthreads();
  for (int i = tid; i < rows; i += kThreads) w.rm[i] = z.y[i] - 2.f * t.y[i];
  __syncthreads();
  // K ru: A rux (the CTA's rows) and A^T ruy (over the grid)
  pass(cx, w.rn, w.rm, w.p, q_out(cx, w.q));
  d[0] = 0.f;
  s[0] = 0.f;
  for (int j = tid; j < n; j += kThreads) d[0] += cx.c_it[j] * w.rn[j];
  for (int i = tid; i < rows; i += kThreads) s[0] += cx.b_it[i] * w.rm[i];
  grid_sum<1>(cx, w.q, s);
  block_sum<1>(d, cx.red);
  const float rut = ut - 2.f * ut_n;
  const float relax = g.relax;
  for (int j = tid; j < n; j += kThreads) {
    float vn = z.vn[j] - cx.dpsx[j] * (w.q[j] + cx.c_it[j] * rut);
    if (relax != 1.f) {
      vn = z.vn[j] + relax * (vn - z.vn[j]);
      t.x[j] = z.x[j] + relax * (t.x[j] - z.x[j]);
    }
    t.vn[j] = vn;
  }
  for (int i = tid; i < rows; i += kThreads) {
    float vm = z.vm[i] - cx.dpsy[i] * (-w.p[i] - (z.s[i] - 2.f * t.s[i]) +
                                       cx.b_it[i] * rut);
    if (relax != 1.f) {
      vm = z.vm[i] + relax * (vm - z.vm[i]);
      t.y[i] = z.y[i] + relax * (t.y[i] - z.y[i]);
      t.s[i] = z.s[i] + relax * (t.s[i] - z.s[i]);
    }
    t.vm[i] = vm;
  }
  float v1_n = fminf(v1 - cx.dpst * (-d[0] - s[0]), 0.f);
  if (relax != 1.f) {
    ut_n = ut + relax * (ut_n - ut);
    v1_n = v1 + relax * (v1_n - v1);
  }
  if (tid == 0) {
    t.sc[0] = ut_n;
    t.sc[1] = v1_n;
  }
  __syncthreads();
}

// Termination criteria at u on the un-normalized data; returns the status
// and fills crits[5]. fp: this thread's share of an m-side sum to be
// taken over the grid with the check's (the Halpern fixed-point norm); on
// return, the grid's total. Every thread of every CTA returns the same
// values.
__device__ int check(const Vecs& u, int k, const Work& w, const MegaArgs& g,
                     Ctx& cx, float (&crits)[5], float& fp) {
  const int n = cx.n, rows = cx.rows, tid = threadIdx.x;
  for (int j = tid; j < n; j += kThreads) w.rn[j] = u.x[j] * cx.sb;
  for (int i = tid; i < rows; i += kThreads) w.rm[i] = u.y[i] * cx.sc;
  __syncthreads();
  pass(cx, w.rn, w.rm, w.p, q_out(cx, w.q));
  const float ut = u.sc[0];
  const bool tau_pos = ut > g.eps_zero;
  const float inv_tau = 1.f / (tau_pos ? ut : 1.f);
  // b.y and the squared norms of the primal and the infeasibility
  // residuals over the CTA's rows
  float s[4] = {0.f, 0.f, 0.f, fp};
  for (int i = tid; i < rows; i += kThreads) {
    s[0] += cx.b_ex[i] * w.rm[i];
    const float usu = u.s[i] * cx.sb;
    const float pi = w.p[i] * inv_tau + usu * inv_tau - cx.b_ex[i];
    const float pinf = w.p[i] + usu;
    s[1] += pi * pi;
    s[2] += pinf * pinf;
  }
  grid_sum<4>(cx, w.q, s);
  fp = s[3];
  float d[3] = {0.f, 0.f, 0.f};
  for (int j = tid; j < n; j += kThreads) {
    d[0] += cx.c_ex[j] * w.rn[j];
    const float dj = cx.c_ex[j] + w.q[j] * inv_tau;
    d[1] += dj * dj;
    d[2] += w.q[j] * w.q[j];
  }
  block_sum<3>(d, cx.red);
  const float cx_ = d[0], by = s[0];
  const float g_x = cx_ * inv_tau, g_y = by * inv_tau;
  crits[0] = sqrtf(s[1]) / (1.f + cx.norm_b);
  crits[1] = sqrtf(d[1]) / (1.f + cx.norm_c);
  crits[2] = fabsf(g_x + g_y) / (1.f + fabsf(g_x) + fabsf(g_y));
  const float m_cx = -cx_, m_by = -by;
  crits[3] = m_cx > g.eps_zero ? sqrtf(s[2]) * cx.norm_c / m_cx : INFINITY;
  crits[4] = m_by > g.eps_zero ? sqrtf(d[2]) * cx.norm_b / m_by : INFINITY;
  const bool conv = tau_pos && crits[0] <= g.eps_acc &&
                    crits[1] <= g.eps_acc && crits[2] <= g.eps_acc;
  const bool unbdd = !tau_pos && crits[3] <= g.eps_inf;
  const bool infeas = !tau_pos && crits[4] <= g.eps_inf;
  if (conv) return kConverged;
  if (unbdd) return kUnbounded;
  if (infeas) return kInfeasible;
  return k >= g.max_iter ? kExcess : kRunning;
}

__device__ void copy_vecs(const Vecs& dst, const Vecs& src, int rows, int n) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    dst.x[j] = src.x[j];
    dst.vn[j] = src.vn[j];
  }
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    dst.y[i] = src.y[i];
    dst.s[i] = src.s[i];
    dst.vm[i] = src.vm[i];
  }
  if (threadIdx.x == 0) {
    dst.sc[0] = src.sc[0];
    dst.sc[1] = src.sc[1];
  }
  __syncthreads();
}

__device__ __forceinline__ float* carve(float*& p, long long len) {
  float* r = p;
  p += len;
  return r;
}

template <bool kTri>
__global__ void __launch_bounds__(kThreads, 1) mega_kernel(MegaArgs g) {
  extern __shared__ float4 dyn4[];
  float* dyn = reinterpret_cast<float*>(dyn4);
  __shared__ float red[4 * kWarps];
  __shared__ float scal[6];
  __shared__ float sred[kScal];
  // blockIdx.y: the lane; blockIdx.x: the CTA's slice of the lane's rows
  const int n = g.n, tid = threadIdx.x, cta = blockIdx.x, lane = blockIdx.y;
  const int r0 = g.row_off[cta], rows = g.row_off[cta + 1] - r0;
  const int rm = g.rows_max;
  const size_t nl = static_cast<size_t>(lane) * n;
  const size_t ml = static_cast<size_t>(lane) * g.m + r0;  // the CTA's rows
  float* p = g.vec_smem ? dyn
                        : g.scratch + (static_cast<size_t>(lane) * g.grid +
                                       cta) * g.ws_floats;
  Vecs z{carve(p, n), carve(p, rm), carve(p, rm), carve(p, n), carve(p, rm),
         scal};
  Vecs t{carve(p, n), carve(p, rm), carve(p, rm), carve(p, n), carve(p, rm),
         scal + 2};
  const Vecs an{carve(p, n), carve(p, rm), carve(p, rm), carve(p, n),
                carve(p, rm), scal + 4};
  const Work w{carve(p, rm), carve(p, n), carve(p, n), carve(p, rm)};
  Ctx cx;
  cx.cta = cta;
  cx.grid = g.grid;
  cx.rows = rows;
  cx.n = n;
  cx.cw = g.col_threads;
  cx.sets = kThreads / g.col_threads;
  cx.steps = min(kSteps, (n + g.col_threads - 1) / g.col_threads);
  if (cx.steps == 3) cx.steps = kSteps;
  cx.ptab = carve(p, static_cast<long long>(kWarps) * rm);
  cx.qtab = carve(p, kThreads * kSteps);
  cx.red = red;
  cx.sred = sred;
  cx.part = g.grid > 1 ? g.partials + static_cast<size_t>(lane) *
                                         (2 * g.grid + 1) * g.ld
                       : nullptr;
  cx.bar = g.barrier + lane;
  cx.target = 0u;
  cx.nred = 0;
  cx.ld = g.ld;
  cx.split = g.split;
  cx.b_it = g.b_it + ml;
  cx.b_ex = g.b_ex + ml;
  cx.dpty = g.dpty + ml;
  cx.dpts = g.dpts + ml;
  cx.dpsy = g.dpsy + ml;
  cx.c_it = g.c_it + nl;
  cx.c_ex = g.c_ex + nl;
  cx.dptx = g.dptx + nl;
  cx.dpsx = g.dpsx + nl;
  const float* ls = g.lane_scal + 8 * static_cast<size_t>(lane);
  cx.dptt = ls[0];
  cx.dpst = ls[1];
  cx.norm_b = ls[2];
  cx.norm_c = ls[3];
  cx.sb = ls[6];
  cx.sc = ls[7];
  cx.kind = g.kind + r0;
  cx.blocks = g.blocks + 3 * g.blk_off[cta];
  cx.nb = g.blk_off[cta + 1] - g.blk_off[cta];
  cx.tri = g.tri + 2 * g.tri_off[cta];
  cx.tri_alpha = g.tri_alpha + g.tri_off[cta];
  cx.nt = g.tri_off[cta + 1] - g.tri_off[cta];
  const float* a_rows =
      g.a + (g.a_shared ? 0 : static_cast<size_t>(lane) * g.m * n) +
      static_cast<size_t>(r0) * n;
  if (g.a_smem[cta]) {
    // the CTA's rows of A, into shared memory once
    float* a_sh = g.vec_smem ? dyn + g.ws_floats : dyn;
    const size_t len = static_cast<size_t>(rows) * n;
    for (size_t e = tid; e < len; e += kThreads) a_sh[e] = __ldg(a_rows + e);
    cx.a = a_sh;
  } else {
    cx.a = a_rows;
  }

  for (int j = tid; j < n; j += kThreads) {
    z.x[j] = g.ux0[nl + j];
    z.vn[j] = g.vn0[nl + j];
  }
  for (int i = tid; i < rows; i += kThreads) {
    z.y[i] = g.uy0[ml + i];
    z.s[i] = g.us0[ml + i];
    z.vm[i] = g.vm0[ml + i];
  }
  if (tid == 0) {
    z.sc[0] = ls[4];
    z.sc[1] = ls[5];
  }
  __syncthreads();

  float crits[5] = {INFINITY, INFINITY, INFINITY, INFINITY, INFINITY};
  int status = kRunning;
  float fp_unused = 0.f;
  if (g.check_at_start) status = check(z, 0, w, g, cx, crits, fp_unused);
  int k = 0;
  if (g.halpern) {
    // restarted reflected Halpern (the host loop's _run_halpern)
    copy_vecs(an, z, rows, n);
    int ke = 0;
    float fp_rst = INFINITY, fp_last = INFINITY;
    while (status == kRunning && k < g.max_iter) {
      for (int s = 0; s < g.check_period; ++s) {
        update<kTri>(z, t, w, g, cx);
        const float wt = (static_cast<float>(ke) + 1.f) /
                         (static_cast<float>(ke) + 2.f);
        const float wa = 1.f - wt;
        for (int j = tid; j < n; j += kThreads) {
          z.x[j] = wt * (2.f * t.x[j] - z.x[j]) + wa * an.x[j];
          z.vn[j] = wt * (2.f * t.vn[j] - z.vn[j]) + wa * an.vn[j];
        }
        for (int i = tid; i < rows; i += kThreads) {
          z.y[i] = wt * (2.f * t.y[i] - z.y[i]) + wa * an.y[i];
          z.s[i] = wt * (2.f * t.s[i] - z.s[i]) + wa * an.s[i];
          z.vm[i] = wt * (2.f * t.vm[i] - z.vm[i]) + wa * an.vm[i];
        }
        if (tid == 0) {
          z.sc[0] = wt * (2.f * t.sc[0] - z.sc[0]) + wa * an.sc[0];
          z.sc[1] = wt * (2.f * t.sc[1] - z.sc[1]) + wa * an.sc[1];
        }
        __syncthreads();
        ++ke;
      }
      k += g.check_period;
      update<kTri>(z, t, w, g, cx);
      // ||T(z) - z||^2: the n side (replicated) here, the m side summed
      // over the grid with the check's sums
      float fn[1] = {0.f};
      for (int j = tid; j < n; j += kThreads) {
        const float dx = t.x[j] - z.x[j], dv = t.vn[j] - z.vn[j];
        fn[0] += dx * dx + dv * dv;
      }
      float fm = 0.f;
      for (int i = tid; i < rows; i += kThreads) {
        const float dy = t.y[i] - z.y[i], ds = t.s[i] - z.s[i];
        const float dv = t.vm[i] - z.vm[i];
        fm += dy * dy + ds * ds + dv * dv;
      }
      block_sum<1>(fn, red);
      status = check(t, k, w, g, cx, crits, fm);
      const float dut = t.sc[0] - z.sc[0], dv1 = t.sc[1] - z.sc[1];
      const float fp = sqrtf(fn[0] + fm + dut * dut + dv1 * dv1);
      const bool restart =
          (fp <= 0.2f * fp_rst) || ((fp <= 0.8f * fp_rst) && (fp > fp_last)) ||
          (static_cast<float>(ke) >=
           fmaxf(0.36f * static_cast<float>(k),
                 4.f * static_cast<float>(g.check_period)));
      if (restart || status != kRunning) {
        const Vecs tmp = z;  // z takes the projected point T(z)
        z = t;
        t = tmp;
      }
      if (restart) {
        copy_vecs(an, z, rows, n);
        ke = 0;
        fp_rst = fp;
      }
      fp_last = fp;
      __syncthreads();
    }
  } else {
    while (status == kRunning && k < g.max_iter) {
      for (int s = 0; s < g.check_period; ++s) {
        update<kTri>(z, t, w, g, cx);
        const Vecs tmp = z;
        z = t;
        t = tmp;
      }
      k += g.check_period;
      status = check(z, k, w, g, cx, crits, fp_unused);
    }
  }

  if (cta == 0) {
    for (int j = tid; j < n; j += kThreads) {
      g.ux[nl + j] = z.x[j];
      g.vn[nl + j] = z.vn[j];
    }
  }
  for (int i = tid; i < rows; i += kThreads) {
    g.uy[ml + i] = z.y[i];
    g.us[ml + i] = z.s[i];
    g.vm[ml + i] = z.vm[i];
  }
  if (cta == 0 && tid == 0) {
    float* so = g.scal_out + 7 * static_cast<size_t>(lane);
    so[0] = z.sc[0];
    so[1] = z.sc[1];
    for (int q = 0; q < 5; ++q) so[2 + q] = crits[q];
    g.int_out[2 * lane] = k;
    g.int_out[2 * lane + 1] = status;
  }
}

}  // namespace

extern "C" {

// Floats of vector workspace one CTA needs for n columns and `rows` rows.
long long totsu_mega_workspace_floats(int n, int rows) {
  return workspace_floats(n, rows);
}

int totsu_mega_struct_size() { return static_cast<int>(sizeof(MegaArgs)); }

int totsu_mega_threads() { return kThreads; }

int totsu_mega_scalars() { return kScal; }

// Shared memory a block may opt in to on the card (bytes), or -1.
int totsu_mega_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

int totsu_mega_solve(const MegaArgs* args, void* stream) {
  const MegaArgs& g = *args;
  const int cw = g.col_threads;
  const bool ok =
      g.lanes >= 1 && g.lanes <= 65535 && g.lane_scal != nullptr &&
      g.m > 0 && g.n > 0 && g.grid >= 1 && g.rows_max >= 1 &&
      cw >= 32 && cw <= kThreads && (cw & (cw - 1)) == 0 &&
      (kThreads / cw == 1 || g.n <= cw * kSteps) &&
      g.ws_floats == workspace_floats(g.n, g.rows_max) &&
      g.ld >= g.n + kScal && g.a_floats >= 0 &&
      (g.vec_smem || g.scratch != nullptr) &&
      (g.grid == 1 || (g.partials != nullptr && g.barrier != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const size_t dyn =
      (static_cast<size_t>(g.vec_smem ? g.ws_floats : 0) + g.a_floats) *
      sizeof(float);
  void (*kernel)(MegaArgs) = g.nt > 0 ? mega_kernel<true> : mega_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  // a lane of several CTAs meets at grid barriers, so the launch is
  // cooperative: refused, never deadlocked, when the lanes' CTAs cannot be
  // resident all at once. A lane of one CTA never waits for another CTA,
  // so any number of lanes launch as a plain grid, in as many waves as
  // the card needs.
  void* params[] = {const_cast<MegaArgs*>(args)};
  const dim3 blocks(g.grid, g.lanes);
  if (g.grid > 1)
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                      blocks, dim3(kThreads), params, dyn,
                                      static_cast<cudaStream_t>(stream));
  else
    err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), blocks,
                           dim3(kThreads), params, dyn,
                           static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* totsu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
