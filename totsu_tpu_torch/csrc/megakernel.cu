// Whole-solve pdhg megakernel: the entire iteration loop in one launch.
//
// Replaces the Pallas kernel totsu_tpu/ops/pallas/megakernel.py
// (solve_mega, body built by _build_kernel) for the zero, R+, SOC, RSOC,
// exponential and power cones with accel '' or 'halpern', optional relax,
// check_at_start and the
// sb/sc unscaling of the criteria. Same algorithm as the host loop of
// totsu_tpu_torch/solver/conic.py; sums run in another order, so results
// agree to f32 reduction-order roundoff.
//
// Bound on the H100: latency, then one SM's bandwidth. At the sizes this
// kernel is for, the host loop's cost is launch overhead, not arithmetic:
// on an H100 80GB HBM3 (700 W power limit) it issues 96 kernel launches
// per iteration and keeps the card busy 7% of its wall time on the n=100
// benchmark LP (PERF.md). One persistent CTA of 1024 threads runs the
// whole loop with no launch and no host round trip per iteration; the
// price is that a single SM streams A four times per iteration (two
// fused matvec pairs, each done as a row pass and a column pass) from L2,
// where A stays resident for problems inside the envelope of fits() in
// ops/kernels/megakernel.py. The design:
//
//  * A (m, n) stays in device memory, read-only (__ldg), so it is served
//    from L2 (and L1 where it fits). The iterate, the Halpern anchor and
//    the temporaries live in shared memory when they fit (kSmemBudget),
//    else in a scratch buffer the wrapper allocates; the code is the same
//    through generic pointers.
//  * A x: a warp per row, lanes walk the row (coalesced), warp-shuffle
//    sum. A^T y: a thread per column, rows split over thread groups when
//    n is small, the groups' partials summed in a fixed order.
//  * Every reduction (dot products, norms, the SOC block norms) is a
//    warp-shuffle + shared-memory reduction in a fixed order, so a solve
//    repeats bit for bit. All threads read the same reduced values, so
//    every thread takes the same branches and the loop needs no broadcast.
//  * The TPU kernel's SOC indicator matmuls become a per-block offset table
//    (start, dim, rotated) and a warp per block that reduces the block's
//    tail norm. RSOC blocks go through the same involutive Givens map on
//    their first two slots; length-1 RSOC blocks are R+ elements.
//  * The TPU kernel evaluates the exp and pow cores lane-wise over the
//    whole m-row, every lane as if it were a block head, and keeps the
//    head lanes (slot masks, two lane-rolls). Here a table of 3-blocks
//    (start, kind, alpha) gives each block one thread, which runs the
//    fixed-trip core of cone_exppow.cuh (the arithmetic of the blocked
//    projection kernel cone_proj.cu) and forms the dual by the Moreau
//    identity in registers. The loop is a template on whether the problem
//    has such blocks: the core adds live values and spills to the loop
//    (PERF.md), so only exp/pow problems run the instantiation that holds
//    it, and the zero/R+/SOC/RSOC problems keep the loop without it. The
//    core sits behind a call that is not inlined.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cone_exppow.cuh"

// Arguments of totsu_mega_solve, filled by ops/kernels/megakernel.py
// (_MegaArgs mirrors this layout; totsu_mega_struct_size checks it). At
// global scope: a type from the unnamed namespace would give the
// extern "C" entry point internal linkage.
struct MegaArgs {
  // problem data, f32 on the device; A is (m, n) row-major
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
  // cone metadata: per-element kind (m,), SOC/RSOC blocks (nb, 3) =
  // start, dim, rot; exp/pow 3-blocks (nt, 2) = start, kind (0 exp, 1
  // pow) and their power exponents (nt,)
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
  float* scratch;   // workspace floats when they do not fit shared memory
  int m, n, nb, nt;
  int max_iter, check_period, halpern, check_at_start;
  float dptt, dpst, norm_b, norm_c, ut0, v10, sb, sc;
  float eps_acc, eps_inf, eps_zero, relax;
};

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// vector workspace bytes kept in shared memory; larger problems use the
// wrapper's scratch buffer (the rest of the SM's shared memory / L1
// capacity stays L1 for A)
constexpr size_t kSmemBudget = 96 * 1024;

constexpr int kRunning = 0, kConverged = 1, kExcess = 2, kUnbounded = 3,
              kInfeasible = 4;
// per-element kinds projected elementwise; the others (2: SOC/RSOC, 3:
// exp, 4: pow) are projected block by block
constexpr int kKindZero = 0, kKindRpos = 1;
constexpr float kInvSqrt2 = 0.70710678118654752440f;

// one iterate (u, v): vectors plus the scalars (ut, v1) in shared memory
struct Vecs {
  float* x;
  float* y;
  float* s;
  float* vn;
  float* vm;
  float* sc;
};

struct Work {
  float* p;   // (m) row-pass result
  float* q;   // (n) column-pass result
  float* rn;  // (n) temporary
  float* rm;  // (m) temporary
};

struct Shared {
  float* red;   // kWarps * 4
  float* part;  // kThreads
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;  // the total is in lane 0
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
#pragma unroll
  for (int q = 0; q < N; ++q) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[q * kWarps + w];
    v[q] = s;
  }
  __syncthreads();
}

// out = A x (m outputs): a warp per row.
__device__ void rows_pass(const float* __restrict__ a, const float* x,
                          float* out, int m, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < m; i += kWarps) {
    const float* row = a + static_cast<size_t>(i) * n;
    float acc = 0.f;
    for (int j = lane; j < n; j += 32) acc = fmaf(__ldg(row + j), x[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[i] = acc;
  }
}

// out = A^T y (n outputs): a thread per column; for n <= 512 the rows are
// split over kThreads / ct groups whose partials are summed in order.
__device__ void cols_pass(const float* __restrict__ a, const float* y,
                          float* out, int m, int n, float* part) {
  const int ct = min(((n + 31) / 32) * 32, kThreads);
  const int groups = kThreads / ct;
  const int tid = threadIdx.x;
  if (groups == 1) {
    for (int j = tid; j < n; j += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < m; ++i)
        acc = fmaf(__ldg(a + static_cast<size_t>(i) * n + j), y[i], acc);
      out[j] = acc;
    }
    return;
  }
  const int g = tid / ct, j = tid % ct;
  if (g < groups && j < n) {
    float acc = 0.f;
    for (int i = g; i < m; i += groups)
      acc = fmaf(__ldg(a + static_cast<size_t>(i) * n + j), y[i], acc);
    part[g * ct + j] = acc;
  }
  __syncthreads();
  if (tid < n) {
    float s = 0.f;
    for (int q = 0; q < groups; ++q) s += part[q * ct + tid];
    out[tid] = s;
  }
  __syncthreads();
}

// Exp and pow 3-blocks of x onto their cones (or duals): a thread per
// block.
__device__ __noinline__ void project_tri(float* x, bool dual, const int* tri,
                                         const float* tri_alpha, int nt) {
  for (int bi = threadIdx.x; bi < nt; bi += kThreads) {
    float* xb = x + tri[2 * bi];
    float v0 = xb[0], v1 = xb[1], v2 = xb[2];
    totsu_cone::proj_block<float>(v0, v1, v2, tri[2 * bi + 1],
                                  tri_alpha[bi], dual);
    xb[0] = v0;
    xb[1] = v1;
    xb[2] = v2;
  }
}

// In-place projection of an m-vector onto K (dual = false) or K*. The
// element kinds, the SOC blocks and the 3-blocks are disjoint, so their
// loops need no barrier between them; the caller's __syncthreads() ends
// them all. kTri: the cone has exp/pow 3-blocks.
template <bool kTri>
__device__ void project(float* x, bool dual, const MegaArgs& g) {
  for (int i = threadIdx.x; i < g.m; i += kThreads) {
    const int k = g.kind[i];
    if (k == kKindZero) {
      if (!dual) x[i] = 0.f;  // the zero cone's dual is everything
    } else if (k == kKindRpos) {
      x[i] = fmaxf(x[i], 0.f);
    }
  }
  // SOC (and rotated SOC) blocks are self-dual: a warp per block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int bi = warp; bi < g.nb; bi += kWarps) {
    const int start = g.blocks[3 * bi];
    const int dim = g.blocks[3 * bi + 1];
    const bool rot = g.blocks[3 * bi + 2] != 0;
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
  if constexpr (kTri) project_tri(x, dual, g.tri, g.tri_alpha, g.nt);
}

// One Pock-Chambolle step t = T(z) (SolverCore::update_vecs).
template <bool kTri>
__device__ void update(const Vecs& z, const Vecs& t, const Work& w,
                       const MegaArgs& g, const Shared& sh) {
  const int m = g.m, n = g.n, tid = threadIdx.x;
  const float ut = z.sc[0], v1 = z.sc[1];
  // K^T v: A vn (m) and A^T vm (n)
  rows_pass(g.a, z.vn, w.p, m, n);
  cols_pass(g.a, z.vm, w.q, m, n, sh.part);
  float d[2] = {0.f, 0.f};
  for (int j = tid; j < n; j += kThreads) d[0] += g.c_it[j] * z.vn[j];
  for (int i = tid; i < m; i += kThreads) d[1] += g.b_it[i] * z.vm[i];
  block_sum<2>(d, sh.red);
  float ut_n = fmaxf(ut - g.dptt * (d[0] + d[1]), 0.f);
  for (int j = tid; j < n; j += kThreads) {
    const float xn = z.x[j] - g.dptx[j] * (-w.q[j] - g.c_it[j] * v1);
    t.x[j] = xn;
    w.rn[j] = z.x[j] - 2.f * xn;
  }
  for (int i = tid; i < m; i += kThreads) {
    t.y[i] = z.y[i] - g.dpty[i] * (w.p[i] - g.b_it[i] * v1);
    t.s[i] = z.s[i] - g.dpts[i] * (-z.vm[i]);
  }
  __syncthreads();
  project<kTri>(t.y, true, g);
  project<kTri>(t.s, false, g);
  __syncthreads();
  for (int i = tid; i < m; i += kThreads) w.rm[i] = z.y[i] - 2.f * t.y[i];
  __syncthreads();
  // K ru: A rux (m) and A^T ruy (n)
  rows_pass(g.a, w.rn, w.p, m, n);
  cols_pass(g.a, w.rm, w.q, m, n, sh.part);
  d[0] = 0.f;
  d[1] = 0.f;
  for (int j = tid; j < n; j += kThreads) d[0] += g.c_it[j] * w.rn[j];
  for (int i = tid; i < m; i += kThreads) d[1] += g.b_it[i] * w.rm[i];
  block_sum<2>(d, sh.red);
  const float rut = ut - 2.f * ut_n;
  const float relax = g.relax;
  for (int j = tid; j < n; j += kThreads) {
    float vn = z.vn[j] - g.dpsx[j] * (w.q[j] + g.c_it[j] * rut);
    if (relax != 1.f) {
      vn = z.vn[j] + relax * (vn - z.vn[j]);
      t.x[j] = z.x[j] + relax * (t.x[j] - z.x[j]);
    }
    t.vn[j] = vn;
  }
  for (int i = tid; i < m; i += kThreads) {
    float vm = z.vm[i] -
               g.dpsy[i] * (-w.p[i] - (z.s[i] - 2.f * t.s[i]) + g.b_it[i] * rut);
    if (relax != 1.f) {
      vm = z.vm[i] + relax * (vm - z.vm[i]);
      t.y[i] = z.y[i] + relax * (t.y[i] - z.y[i]);
      t.s[i] = z.s[i] + relax * (t.s[i] - z.s[i]);
    }
    t.vm[i] = vm;
  }
  float v1_n = fminf(v1 - g.dpst * (-d[0] - d[1]), 0.f);
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
// and fills crits[5]. Every thread returns the same values.
__device__ int check(const Vecs& u, int k, const Work& w, const MegaArgs& g,
                     const Shared& sh, float (&crits)[5]) {
  const int m = g.m, n = g.n, tid = threadIdx.x;
  for (int j = tid; j < n; j += kThreads) w.rn[j] = u.x[j] * g.sb;
  for (int i = tid; i < m; i += kThreads) w.rm[i] = u.y[i] * g.sc;
  __syncthreads();
  rows_pass(g.a, w.rn, w.p, m, n);
  cols_pass(g.a, w.rm, w.q, m, n, sh.part);
  float d[2] = {0.f, 0.f};
  for (int j = tid; j < n; j += kThreads) d[0] += g.c_ex[j] * w.rn[j];
  for (int i = tid; i < m; i += kThreads) d[1] += g.b_ex[i] * w.rm[i];
  block_sum<2>(d, sh.red);
  const float cx = d[0], by = d[1];
  const float ut = u.sc[0];
  const bool tau_pos = ut > g.eps_zero;
  const float inv_tau = 1.f / (tau_pos ? ut : 1.f);
  float r[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = tid; i < m; i += kThreads) {
    const float usu = u.s[i] * g.sb;
    const float pi = w.p[i] * inv_tau + usu * inv_tau - g.b_ex[i];
    const float pinf = w.p[i] + usu;
    r[0] += pi * pi;
    r[2] += pinf * pinf;
  }
  for (int j = tid; j < n; j += kThreads) {
    const float dj = g.c_ex[j] + w.q[j] * inv_tau;
    r[1] += dj * dj;
    r[3] += w.q[j] * w.q[j];
  }
  block_sum<4>(r, sh.red);
  const float g_x = cx * inv_tau, g_y = by * inv_tau;
  crits[0] = sqrtf(r[0]) / (1.f + g.norm_b);
  crits[1] = sqrtf(r[1]) / (1.f + g.norm_c);
  crits[2] = fabsf(g_x + g_y) / (1.f + fabsf(g_x) + fabsf(g_y));
  const float m_cx = -cx, m_by = -by;
  crits[3] = m_cx > g.eps_zero ? sqrtf(r[2]) * g.norm_c / m_cx : INFINITY;
  crits[4] = m_by > g.eps_zero ? sqrtf(r[3]) * g.norm_b / m_by : INFINITY;
  const bool conv = tau_pos && crits[0] <= g.eps_acc &&
                    crits[1] <= g.eps_acc && crits[2] <= g.eps_acc;
  const bool unbdd = !tau_pos && crits[3] <= g.eps_inf;
  const bool infeas = !tau_pos && crits[4] <= g.eps_inf;
  if (conv) return kConverged;
  if (unbdd) return kUnbounded;
  if (infeas) return kInfeasible;
  return k >= g.max_iter ? kExcess : kRunning;
}

__device__ void copy_vecs(const Vecs& dst, const Vecs& src, int m, int n) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    dst.x[j] = src.x[j];
    dst.vn[j] = src.vn[j];
  }
  for (int i = threadIdx.x; i < m; i += kThreads) {
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

__device__ __forceinline__ float* carve(float*& p, int len) {
  float* r = p;
  p += len;
  return r;
}

template <bool kTri>
__global__ void __launch_bounds__(kThreads, 1)
mega_kernel(MegaArgs g, int use_smem) {
  extern __shared__ float dyn[];
  __shared__ float red[4 * kWarps];
  __shared__ float part[kThreads];
  __shared__ float scal[6];
  const int m = g.m, n = g.n, tid = threadIdx.x;
  const Shared sh{red, part};
  float* p = use_smem ? dyn : g.scratch;
  Vecs z{carve(p, n), carve(p, m), carve(p, m), carve(p, n), carve(p, m),
         scal};
  Vecs t{carve(p, n), carve(p, m), carve(p, m), carve(p, n), carve(p, m),
         scal + 2};
  const Vecs an{carve(p, n), carve(p, m), carve(p, m), carve(p, n),
                carve(p, m), scal + 4};
  const Work w{carve(p, m), carve(p, n), carve(p, n), carve(p, m)};

  for (int j = tid; j < n; j += kThreads) {
    z.x[j] = g.ux0[j];
    z.vn[j] = g.vn0[j];
  }
  for (int i = tid; i < m; i += kThreads) {
    z.y[i] = g.uy0[i];
    z.s[i] = g.us0[i];
    z.vm[i] = g.vm0[i];
  }
  if (tid == 0) {
    z.sc[0] = g.ut0;
    z.sc[1] = g.v10;
  }
  __syncthreads();

  float crits[5] = {INFINITY, INFINITY, INFINITY, INFINITY, INFINITY};
  int status = kRunning;
  if (g.check_at_start) status = check(z, 0, w, g, sh, crits);
  int k = 0;
  if (g.halpern) {
    // restarted reflected Halpern (the host loop's _run_halpern)
    copy_vecs(an, z, m, n);
    int ke = 0;
    float fp_rst = INFINITY, fp_last = INFINITY;
    while (status == kRunning && k < g.max_iter) {
      for (int s = 0; s < g.check_period; ++s) {
        update<kTri>(z, t, w, g, sh);
        const float wt = (static_cast<float>(ke) + 1.f) /
                         (static_cast<float>(ke) + 2.f);
        const float wa = 1.f - wt;
        for (int j = tid; j < n; j += kThreads) {
          z.x[j] = wt * (2.f * t.x[j] - z.x[j]) + wa * an.x[j];
          z.vn[j] = wt * (2.f * t.vn[j] - z.vn[j]) + wa * an.vn[j];
        }
        for (int i = tid; i < m; i += kThreads) {
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
      update<kTri>(z, t, w, g, sh);
      float fp2[1] = {0.f};
      for (int j = tid; j < n; j += kThreads) {
        const float dx = t.x[j] - z.x[j], dv = t.vn[j] - z.vn[j];
        fp2[0] += dx * dx + dv * dv;
      }
      for (int i = tid; i < m; i += kThreads) {
        const float dy = t.y[i] - z.y[i], ds = t.s[i] - z.s[i];
        const float dv = t.vm[i] - z.vm[i];
        fp2[0] += dy * dy + ds * ds + dv * dv;
      }
      block_sum<1>(fp2, red);
      const float dut = t.sc[0] - z.sc[0], dv1 = t.sc[1] - z.sc[1];
      const float fp = sqrtf(fp2[0] + dut * dut + dv1 * dv1);
      status = check(t, k, w, g, sh, crits);
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
        copy_vecs(an, z, m, n);
        ke = 0;
        fp_rst = fp;
      }
      fp_last = fp;
      __syncthreads();
    }
  } else {
    while (status == kRunning && k < g.max_iter) {
      for (int s = 0; s < g.check_period; ++s) {
        update<kTri>(z, t, w, g, sh);
        const Vecs tmp = z;
        z = t;
        t = tmp;
      }
      k += g.check_period;
      status = check(z, k, w, g, sh, crits);
    }
  }

  for (int j = tid; j < n; j += kThreads) {
    g.ux[j] = z.x[j];
    g.vn[j] = z.vn[j];
  }
  for (int i = tid; i < m; i += kThreads) {
    g.uy[i] = z.y[i];
    g.us[i] = z.s[i];
    g.vm[i] = z.vm[i];
  }
  if (tid == 0) {
    g.scal_out[0] = z.sc[0];
    g.scal_out[1] = z.sc[1];
    for (int q = 0; q < 5; ++q) g.scal_out[2 + q] = crits[q];
    g.int_out[0] = k;
    g.int_out[1] = status;
  }
}

}  // namespace

extern "C" {

// Floats of vector workspace the kernel needs for an (m, n) problem; the
// wrapper's scratch buffer must hold this many when they do not fit
// shared memory.
long long totsu_mega_workspace_floats(int m, int n) {
  return 8LL * n + 11LL * m;
}

int totsu_mega_struct_size() { return static_cast<int>(sizeof(MegaArgs)); }

int totsu_mega_solve(const MegaArgs* args, void* stream) {
  const size_t bytes =
      static_cast<size_t>(totsu_mega_workspace_floats(args->m, args->n)) *
      sizeof(float);
  const int use_smem = bytes <= kSmemBudget;
  if (!use_smem && args->scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t dyn = use_smem ? bytes : 0;
  void (*kernel)(MegaArgs, int) =
      args->nt > 0 ? mega_kernel<true> : mega_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(*args,
                                                                  use_smem);
  return static_cast<int>(cudaGetLastError());
}

const char* totsu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
