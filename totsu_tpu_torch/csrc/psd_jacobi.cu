// Kernel J: the PSD-cone projection of packed symmetric blocks by
// parallel-order cyclic Jacobi, all blocks of a cone factor in one launch,
// one thread-block cluster of C CTAs per block matrix (C = 1: one CTA).
//
// Replaces what XLA fuses for the JAX package from totsu_tpu/ops/jacobi.py
// jacobi_eigh (:102) and psd_part_jacobi (:151), reached through
// sympack.proj_psd_packed(method='jacobi') (there is no Pallas kernel: XLA
// compiles the 10-14 sweeps of k-1 rounds into one program). Eager PyTorch
// would launch about 40 operations per round (ops/jacobi.py _round), so on
// the card the projection is this one launch.
//
// What it computes, as ops/jacobi.py (its plain version): unpack the
// scaled-vec input (off-diagonals over sqrt2), pad an odd order with one
// decoupled zero row and column, set V = I, then run `sweeps` sweeps of
// kp-1 rounds of the round-robin schedule. In a round every row pair
// (i, j), i < j, gets the symmetric Schur rotation: theta = (a_jj - a_ii) /
// (2 a_ij), t = sign(theta) / (|theta| + sqrt(theta^2 + 1)), t = 1 at theta
// = 0 (the antisymmetric tie-break: row j takes -1), c = rsqrt(t^2 + 1), s
// = t c for row i and -s for row j, and c = 1, s = 0 at an exactly zero
// pivot. A <- J^T A J is a 2 x 2 update of each pair of pairs P <= Q; V <-
// V J mixes two columns. Last, the eigenvalues are clipped at 0 and X+ =
// U U^T, U = V diag(sqrt(max(w, 0))), is written back packed and scaled.
//
// Layout: A by position, not by row. The schedule keeps player 0 at
// position 0 and moves every other player one position on per round
// (next(p) = p + 1, next(kp-1) = 1), and a round pairs position P with
// kp-1-P. So A is kept as the matrix of positions: the 2 x 2 block of
// pairs (P, Q) is always the same four stored values (a block slot; value
// e of slot l at e * slots + l), and after its rotation each value moves
// to the block of its next positions. Every index of the round loop is
// fixed per thread and computed once before the sweeps: the thread's block
// slots and the four destinations of each, from the block table that the
// wrapper builds (ops/kernels/psd_jacobi.py block_table). The round number
// enters only through the players at a pair's two positions, p - r (+ kp-1
// below 1), with no division. A is double-buffered (read buffer r % 2,
// write the other), and each entry is stored once, so symmetry is exact by
// construction. Pair P's pivot and diagonals of a round are its diagonal
// block (P, P)'s values.
//
// One barrier a round. After it every warp computes the c and s of all
// pairs into its own table (lane X: pairs X, X+32, ...), with operations
// that do not fuse or reorder, so that every copy is bitwise equal; there
// is no barrier between the rotations and the update. Two layouts:
// - A whole in each CTA (where A's two buffers fit one CTA): every CTA of
//   the cluster updates all of A alike, reads each pair's pivot and
//   diagonals from its diagonal block, and ends the round on its own
//   barrier (__syncwarp for one warp); the cluster splits V's rows (V^T[b]
//   [i], column b of V in a row, split by i), so V <- V J is the CTA's own
//   work, and the rebuild.
// - A split over the cluster (k past about 150): each CTA updates its
//   share of the block slots, a compact patch of the (P, Q) triangle plus
//   an equal run of the band Q - P <= 2, and sends the values that leave
//   it into the other CTAs' shared memory (distributed shared memory,
//   cg::cluster_group::map_shared_rank); whoever writes a value that is
//   the next round's pivot or diagonal also writes it into a small array,
//   slot (r + 1) % 2, in every CTA; the round ends on one cluster barrier
//   (barrier.cluster arrive.release / wait.acquire).
// The rebuild U U^T is split by output rows: each CTA scales its rows of
// V, then copies the other CTAs' rows in turn and writes its tiles. Where
// A and V do not fit 16 CTAs' shared memory, they and the table live in a
// global scratch (one CTA per block, the first layout's code).
//
// Bound on the H100: operations, about 6 kp^2 per round and 2 k per output
// entry of the rebuild, against a few bytes in and out. What a round costs
// is its chain of steps and their shared-memory traffic: the rotations
// (each warp all h pairs), the block slots' loads and stores, V's rows,
// the barrier; with A split, the values and pivots sent to other CTAs and
// the cluster barrier (jacobi_phases.py times each). The plan
// (ops/kernels/psd_jacobi.py plan) spreads a large block over a cluster
// and keeps a small one on one warp.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// threads per CTA at most (the plan picks up to this)
constexpr int kMaxThreads = 512;
// CTAs per cluster at most (above 8 a non-portable size)
constexpr int kMaxCluster = 16;
// ints per block slot of the table
constexpr int kDesc = 8;

// type: 16 bytes of T (W of them); pair: a pair's c and s
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  using pair = float2;
  static constexpr int W = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  using pair = double2;
  static constexpr int W = 2;
};

__host__ __device__ inline long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// the regions of one block matrix, in elements (W = 16 bytes of them):
// A's two buffers of 4 values per slot (value e of slot l at e * slots +
// l, so that a warp's neighbouring slots load and store neighbouring
// words; later the rebuild's staging), V's rows, the pivot array's two
// slots (kp diagonals, kp/2 pivots and a sink for the values that are
// neither), and per warp (`warp` values each) its c and s of each pair
// and the list of the pairs it needs (kp/2 ints)
struct Sizes {
  long long region, v, piv, warp, rot;
  __host__ __device__ Sizes(int kp, int threads, int rows, int slots,
                            int w) {
    region = round_up(8LL * slots > 1LL * kp * rows ? 8LL * slots
                                                    : 1LL * kp * rows,
                      w);
    v = 1LL * kp * rows;
    piv = round_up(2LL * (kp + kp / 2 + 1), w);
    warp = round_up(kp, w) + round_up(4LL * (kp / 2), 16) * w / 16;
    rot = (threads / 32) * warp;
  }
};

__device__ __forceinline__ int tri(int c) { return c * (c + 1) / 2; }

// the player at position p in round r of the round-robin tournament over
// n + 1 players (ops/jacobi.py _schedule), 0 <= r < n
__device__ __forceinline__ int player(int p, int r, int n) {
  return p == 0 ? 0 : (p > r ? p - r : p - r + n);
}

// the generic address of the same shared-memory byte in CTA `rank` of the
// cluster (distributed shared memory; loads and stores through it are
// ordinary generic ones)
template <typename P>
__device__ __forceinline__ P* in_cta(P* p, unsigned rank) {
  return cg::this_cluster().map_shared_rank(p, static_cast<int>(rank));
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

// one MUFU each, denormal inputs flushed (their callers' inputs are >= 1,
// or 2 a_ij, whose flush to 0 makes theta infinite and the rotation the
// identity, as a pivot that small does in the plain version)
__device__ __forceinline__ float rcp_ftz(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// c and s (for the pair's low position) of the pair whose low position
// holds diagonal dl and high position dh, pivot a; `lim`: the low position
// holds the smaller row (row i). t = sign(theta) / (|theta| + sqrt(theta^2
// + 1)) with theta^2 + 1 held below 1e36 (t ~ 1 / |theta| past 1e18, where
// the rotation is the identity to the last bit anyway), t = +1 at theta =
// 0, c = 1 and s = 0 at a zero pivot; no branch, and nothing fuses or
// reorders (the _rn intrinsics), so every warp that computes it gets the
// same bits. Its reciprocals and square roots are the MUFU approximations:
// they move the angle by an ulp or two, not J's orthogonality, which
// rests on c = rsqrt(t^2 + 1) and s = t c.
__device__ __forceinline__ void rotation(float dl, float dh, float a,
                                         bool lim, float& c, float& sl) {
  const float aii = lim ? dl : dh, ajj = lim ? dh : dl;
  const float theta =
      __fmul_rn(__fsub_rn(ajj, aii), rcp_ftz(__fmul_rn(2.0f, a)));
  const float u = fabsf(theta);
  const float x = fminf(__fmaf_rn(u, u, 1.0f), 1e36f);
  float t = rcp_ftz(__fadd_rn(u, __fmul_rn(x, rsqrt_ftz(x))));
  t = theta < 0.0f ? -t : t;
  const float cc = rsqrt_ftz(__fmaf_rn(t, t, 1.0f));
  const float s = a != 0.0f ? __fmul_rn(t, cc) : 0.0f;
  c = a != 0.0f ? cc : 1.0f;
  sl = lim ? s : -s;
}

__device__ __forceinline__ void rotation(double dl, double dh, double a,
                                         bool lim, double& c, double& sl) {
  const double aii = lim ? dl : dh, ajj = lim ? dh : dl;
  const double theta =
      __ddiv_rn(__dsub_rn(ajj, aii), __dmul_rn(2.0, a != 0.0 ? a : 1.0));
  const double u = fabs(theta);
  const double x = fmin(__fma_rn(u, u, 1.0), 1e300);
  double t = __drcp_rn(__dadd_rn(u, __dsqrt_rn(x)));
  t = theta < 0.0 ? -t : t;
  const double cc = rsqrt(__fma_rn(t, t, 1.0));
  const double s = a != 0.0 ? __dmul_rn(t, cc) : 0.0;
  c = a != 0.0 ? cc : 1.0;
  sl = lim ? s : -s;
}

// V's two rows of a pair, W values each: v1 <- v1 c - v2 s, v2 <- v2 c +
// v1 s
__device__ __forceinline__ void rotate_rows(float4& a, float4& b, float c,
                                            float s) {
  const float4 u = a, v = b;
  a = make_float4(u.x * c - v.x * s, u.y * c - v.y * s, u.z * c - v.z * s,
                  u.w * c - v.w * s);
  b = make_float4(v.x * c + u.x * s, v.y * c + u.y * s, v.z * c + u.z * s,
                  v.w * c + u.w * s);
}
__device__ __forceinline__ void rotate_rows(double2& a, double2& b, double c,
                                            double s) {
  const double2 u = a, v = b;
  a = make_double2(u.x * c - v.x * s, u.y * c - v.y * s);
  b = make_double2(v.x * c + u.x * s, v.y * c + u.y * s);
}

struct Args {
  const void* in;
  void* out;
  void* scratch;     // the global layout's regions, one set per block
  const int* table;  // (cluster or 1, slots, kDesc) block table
  int k, kp, sweeps, scaled, cluster, rows, slots;
};

// SMEM: A, V and the warps' tables in shared memory; else in the global
// scratch (one CTA). SPLIT: A's block slots split over the cluster's
// CTAs, the values that leave a CTA and the next round's pivots sent
// into the others' shared memory, a cluster barrier a round; else every
// CTA holds and updates the whole of A (the cluster, where there is one,
// splits V's rows and the rebuild), reads each pair's pivot and
// diagonals from the pair's diagonal block, and the round's barrier is
// its own (__syncwarp for one warp).
template <typename T, bool SMEM, bool SPLIT>
__global__ void __launch_bounds__(kMaxThreads)
    psd_jacobi_kernel(const Args g) {
  using VT = typename Vec<T>::type;
  constexpr int W = Vec<T>::W;
  // block slots a thread holds in registers (where it has at most this
  // many; else it reads them from the table each round)
  constexpr int kSlots = SPLIT ? 4 : 6;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = g.k, kp = g.kp, h = kp / 2, n = kp - 1, C = g.cluster;
  // a slot of the pivot array: diagonals by position, pivots by pair, and
  // the sink (index kp + h)
  const int rows = g.rows, slots = g.slots, G = rows / W, pivn = kp + h + 1;
  const int rank = static_cast<int>(blockIdx.x) % C;
  const long long mat = blockIdx.x / C;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const Sizes sz(kp, nt, rows, slots, W);
  const long long buf = 4LL * slots;  // elements of one A buffer

  T *PA, *V, *piv, *rot;
  if constexpr (SMEM) {
    PA = reinterpret_cast<T*>(smem_raw);
    V = PA + sz.region;
    piv = V + sz.v;
    rot = piv + sz.piv;
  } else {
    PA = static_cast<T*>(g.scratch) + mat * (sz.region + sz.v + sz.rot);
    V = PA + sz.region;
    rot = V + sz.v;
    piv = reinterpret_cast<T*>(smem_raw);
  }
  // the whole of A: each pair's diagonal block slot, where the pivot
  // array would be
  int* dslot = reinterpret_cast<int*>(piv);
  // this warp's c and s (of the low position) of each pair, and the pairs
  // it needs
  using CS = typename Vec<T>::pair;
  const int warp = tid >> 5;
  CS* rcs = reinterpret_cast<CS*>(rot + warp * sz.warp);
  int* need = reinterpret_cast<int*>(rot + warp * sz.warp + round_up(kp, W));

  const T inv_sqrt2 = static_cast<T>(0.70710678118654752440);
  const T sqrt2 = static_cast<T>(1.41421356237309504880);
  const T* x = static_cast<const T*>(g.in) + mat * tri(k);
  auto entry = [&](int i, int j) -> T {  // the input's A(i, j), padded
    if (i >= k || j >= k) return T(0);
    const T v = x[i <= j ? tri(j) + i : tri(i) + j];
    return (g.scaled && i != j) ? v * inv_sqrt2 : v;
  };
  const int* tab =
      g.table + (SPLIT ? static_cast<long long>(rank) * slots * kDesc : 0);
  // a warp's slots: a run of sw (a compact patch of the triangle); lane
  // `lane` takes the run's slots lane, lane + 32, ...
  const int sw = (slots + (nt >> 5) - 1) / (nt >> 5), s0 = warp * sw;
  const int s1 = min(s0 + sw, slots);
  const bool held = SMEM && sw <= 32 * kSlots;

  // ---- this thread's block slots, held in registers for the sweeps
  // (on the diagonal block the mirror value goes to its own slot of the
  // other buffer, which nobody reads, and a value that is no next pivot or
  // diagonal to the pivot array's sink: every store is unconditional)
  int pq[kSlots];
  unsigned dst[kSlots][4], pv[kSlots][2];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int l = s0 + lane + 32 * j;
    pq[j] = -1;
    if (held && l < s1) {
      const int4 a = *reinterpret_cast<const int4*>(tab + l * kDesc);
      const int4 b = *reinterpret_cast<const int4*>(tab + l * kDesc + 4);
      pq[j] = a.x;
      dst[j][0] = a.y;
      dst[j][1] = a.z;
      dst[j][2] = a.w;
      dst[j][3] = b.x;
      pv[j][0] = b.y;
      pv[j][1] = b.z;
    }
  }

  // ---- A at round 0 (positions are rows), the pivot array of round 0 in
  // every CTA or each pair's diagonal slot, V = I on this CTA's rows
  auto init_block = [&](int pqv, long long l) {
    const int P = pqv & 0xFFFF, Q = pqv >> 16;
    T* a = PA + l;
    a[0] = entry(P, Q);
    a[slots] = entry(P, n - Q);
    a[2 * slots] = P == Q ? T(0) : entry(n - P, Q);
    a[3 * slots] = entry(n - P, n - Q);
    if (!SPLIT && P == Q) dslot[P] = static_cast<int>(l);
  };
  if (held) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (pq[j] >= 0) init_block(pq[j], s0 + lane + 32 * j);
  } else {
    for (int l = s0 + lane; l < s1; l += 32) {
      const int pqv = tab[l * kDesc];
      if (pqv >= 0) init_block(pqv, l);
    }
  }
  if (SPLIT) {
    for (int p = tid; p < kp; p += nt) piv[p] = entry(p, p);
    for (int X = tid; X < h; X += nt) piv[kp + X] = entry(X, n - X);
  }
  for (long long e = tid; e < sz.v; e += nt) {
    const int b = static_cast<int>(e / rows);
    V[e] = (b == rank * rows + static_cast<int>(e - 1LL * b * rows)) ? T(1)
                                                                      : T(0);
  }
  // the barrier of the CTAs that share data: the cluster's, or this CTA's
  auto group_sync = [&](bool cluster) {
    if (cluster)
      cluster_sync();
    else if (nt == 32)
      __syncwarp();
    else
      __syncthreads();
  };
  // this thread's V items (pair Q, group gg of W rows): items tid, tid +
  // nt, ...; the first, and the step to the next, without a division in
  // the loop
  const int hg = h * G;
  const int q0 = tid / G, g0 = tid % G, dq = nt / G, dg = nt % G;
  auto next_item = [&](int& Q, int& gg) {
    gg += dg;
    Q += dq;
    if (gg >= G) {
      gg -= G;
      ++Q;
    }
  };

  // the pairs this warp needs (its slots' and its V items'), listed once:
  // marked, then packed in place in order (a ballot a step of 32). With A
  // whole in f32, where a rotation is cheap, every warp computes every
  // pair instead, which keeps the warps' rounds even (measured:
  // jacobi_timing.py, PERF.md)
  constexpr bool kList = SPLIT || sizeof(T) == 8;
  int nneed = 0;
  if constexpr (kList) {
    for (int X = lane; X < h; X += 32) need[X] = 0;
    __syncwarp();
    auto mark = [&](int pqv) {
      need[pqv & 0xFFFF] = 1;
      need[pqv >> 16] = 1;
    };
    if (held) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j)
        if (pq[j] >= 0) mark(pq[j]);
    } else {
      for (int l = s0 + lane; l < s1; l += 32)
        if (tab[l * kDesc] >= 0) mark(tab[l * kDesc]);
    }
    for (int it = tid, Q = q0, gg = g0; it < hg; it += nt, next_item(Q, gg))
      need[Q] = 1;
    __syncwarp();
    for (int X0 = 0; X0 < h; X0 += 32) {
      const bool on = X0 + lane < h && need[X0 + lane];
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, on);
      if (on) need[nneed + __popc(ballot & ((1u << lane) - 1))] = X0 + lane;
      nneed += __popc(ballot);
    }
  }
  group_sync(C > 1);  // (the cluster's CTAs are all running)

  int par = 0;  // A's buffer and the pivot array's slot of this round
  for (int sw = 0; sw < g.sweeps; ++sw) {
    for (int r = 0; r < n; ++r) {
      const T* cur = PA + par * buf;
      const T* pc = piv + par * pivn;
      // the rotation of every pair this warp needs, into its table
      for (int i = lane; i < (kList ? nneed : h); i += 32) {
        const int X = kList ? need[i] : i;
        T dl, a, dh, c, s;
        if constexpr (SPLIT) {
          dl = pc[X];
          dh = pc[n - X];
          a = pc[kp + X];
        } else {
          const T* d = cur + dslot[X];
          dl = d[0];
          a = d[slots];
          dh = d[3 * slots];
        }
        rotation(dl, dh, a, X == 0 || r < X || r >= n - X, c, s);
        rcs[X] = CS{c, s};
      }
      __syncwarp();
      const int nxt = par ^ 1;
      // a value's destination d: CTA d >> 24 of the cluster, element d &
      // 0xFFFFFF (value e * slots + slot) of its buffer nxt
      auto put = [&](unsigned d, T val) {
        if constexpr (SPLIT)
          *in_cta(PA + nxt * buf + (d & 0xFFFFFFu), d >> 24) = val;
        else
          PA[nxt * buf + d] = val;
      };
      // the next round's pivot array, in every CTA of the cluster
      auto put_piv = [&](unsigned idx, T val) {
        if (idx == unsigned(pivn - 1)) return;
        T* const at = piv + nxt * pivn + idx;
        for (int q = 0; q < C; ++q) *in_cta(at, q) = val;
      };
      // A <- J^T A J on a block of pairs (P, Q): rows P and kp-1-P, columns
      // Q and kp-1-Q (on P == Q the two off-diagonal values are one, the
      // pivot, written from row P); the values go to their next positions
      auto do_block = [&](int pqv, long long l, unsigned d0, unsigned d1,
                          unsigned d2, unsigned d3, unsigned p01,
                          unsigned p23) {
        const int P = pqv & 0xFFFF, Q = pqv >> 16;
        const T x11 = cur[l], x12 = cur[slots + l], x22 = cur[3 * slots + l];
        const T x21 = P == Q ? x12 : cur[2 * slots + l];
        const CS csp = rcs[P], csq = rcs[Q];
        const T cp = csp.x, sp = csp.y, cq = csq.x, sq = csq.y;
        const T b11 = x11 * cq - x12 * sq, b12 = x12 * cq + x11 * sq;
        const T b21 = x21 * cq - x22 * sq, b22 = x22 * cq + x21 * sq;
        const T y11 = b11 * cp - b21 * sp, y12 = b12 * cp - b22 * sp;
        const T y21 = b21 * cp + b11 * sp, y22 = b22 * cp + b12 * sp;
        put(d0, y11);
        put(d1, y12);
        put(d2, y21);
        put(d3, y22);
        if constexpr (SPLIT) {
          put_piv(p01 & 0xFFFFu, y11);
          put_piv(p01 >> 16, y12);
          put_piv(p23 & 0xFFFFu, y21);
          put_piv(p23 >> 16, y22);
        }
      };
      if (held) {
#pragma unroll
        for (int j = 0; j < kSlots; ++j)
          if (pq[j] >= 0)
            do_block(pq[j], s0 + lane + 32 * j, dst[j][0], dst[j][1],
                     dst[j][2], dst[j][3], pv[j][0], pv[j][1]);
      } else {
        for (int l = s0 + lane; l < s1; l += 32) {
          const int4 a = *reinterpret_cast<const int4*>(tab + l * kDesc);
          const int4 b = *reinterpret_cast<const int4*>(tab + l * kDesc + 4);
          if (a.x >= 0)
            do_block(a.x, l, a.y, a.z, a.w, b.x, b.y, b.z);
        }
      }
      // V <- V J on this CTA's rows: columns player(Q) and player(kp-1-Q)
      {
        int Q = q0, gg = g0;
        for (int it = tid; it < hg; it += nt) {
          VT* p1 = reinterpret_cast<VT*>(V + 1LL * player(Q, r, n) * rows) +
                   gg;
          VT* p2 =
              reinterpret_cast<VT*>(V + 1LL * player(n - Q, r, n) * rows) +
              gg;
          VT v1 = *p1, v2 = *p2;
          const CS cs = rcs[Q];
          rotate_rows(v1, v2, cs.x, cs.y);
          *p1 = v1;
          *p2 = v2;
          next_item(Q, gg);
        }
      }
      group_sync(SPLIT);
      par = nxt;
    }
  }

  // ---- X+ = U U^T, U = V diag(sqrt(max(w, 0))); after whole sweeps the
  // positions are the rows again, and w is the pivot array's diagonal (or
  // the diagonal blocks' diagonals)
  auto eigenvalue = [&](int b) -> T {
    if constexpr (SPLIT) return piv[par * pivn + b];
    const T* cur = PA + par * buf;
    return b < h ? cur[dslot[b]] : cur[dslot[n - b] + 3 * slots];
  };
  for (long long e = tid; e < sz.v; e += nt)
    V[e] *= sqrt(max(eigenvalue(static_cast<int>(e / rows)), T(0)));
  group_sync(C > 1);
  T* y = static_cast<T*>(g.out) + mat * tri(k);
  const int r0 = rank * rows;
  for (int j = rank; j < C && r0 < k && j * rows < k; ++j) {
    const T* U = V;
    if (j != rank) {  // CTA j's rows of U, copied here
      const VT* src = in_cta(reinterpret_cast<VT*>(V), j);
      VT* stage = reinterpret_cast<VT*>(PA);
      for (int e = tid; e < kp * G; e += nt) stage[e] = src[e];
      __syncthreads();
      U = PA;
    }
    const int c0 = j * rows;
    for (int e = tid; e < rows * rows; e += nt) {
      const int rl = e / rows, cl = e - rl * rows;
      const int R = r0 + rl, Cc = c0 + cl;
      if (R > Cc || Cc >= k) continue;
      T acc = T(0);
      for (int b = 0; b < kp; ++b) acc += V[b * rows + rl] * U[b * rows + cl];
      y[tri(Cc) + R] = (g.scaled && R != Cc) ? acc * sqrt2 : acc;
    }
    __syncthreads();
  }
  if (C > 1) cluster_sync();  // no CTA leaves while another reads it
}

// dynamic shared memory of a launch (bytes)
long long smem_bytes(int kp, int threads, int rows, int slots, int elem,
                     int smem_layout) {
  const Sizes sz(kp, threads, rows, slots, 16 / elem);
  return elem * (smem_layout ? sz.region + sz.v + sz.piv + sz.rot : sz.piv);
}

// global scratch of one block matrix in the global layout (elements)
long long scratch_elems(int kp, int threads, int rows, int slots, int elem) {
  const Sizes sz(kp, threads, rows, slots, 16 / elem);
  return sz.region + sz.v + sz.rot;
}

cudaLaunchConfig_t config(int count, int cluster, int threads,
                          long long smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(count) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

using Kernel = void (*)(const Args);

// the instantiation of a layout: shared memory or global, A split over
// the cluster or whole in each CTA
template <typename T>
Kernel kernel_of(int smem_layout, int split) {
  if (!smem_layout) return psd_jacobi_kernel<T, false, false>;
  return split ? psd_jacobi_kernel<T, true, true>
               : psd_jacobi_kernel<T, true, false>;
}

cudaError_t set_attributes(Kernel kern, int cluster, long long smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (cluster > 8)
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return cudaSuccess;
}

bool valid(int k, int cluster, int threads, int rows, int slots,
           int smem_layout, int split, int elem) {
  const int kp = k + (k & 1), h = kp / 2;
  const int c = cluster;
  const int nblk = h * (h + 1) / 2;
  return k > 0 && threads >= 32 && threads <= kMaxThreads &&
         threads % 32 == 0 && (c == 1 || c == 2 || c == 4 || c == 8 ||
                               c == kMaxCluster) &&
         (smem_layout || c == 1) && (!split || (smem_layout && c > 1)) &&
         rows % (16 / elem) == 0 && 1LL * rows * c >= kp &&
         slots == (split ? (nblk + c - 1) / c : nblk);
}

template <typename T>
int launch(const T* in, T* out, T* scratch, const int* table, int k,
           int count, int sweeps, int scaled, int cluster, int threads,
           int rows, int slots, int smem_layout, int split, long long smem,
           void* stream) {
  if (count <= 0 || k <= 0) return 0;
  // the plan's launch, checked: whole warps, a cluster size the card takes,
  // the layout's slots and bytes, a scratch for the global layout
  if (!valid(k, cluster, threads, rows, slots, smem_layout, split,
             sizeof(T)) ||
      sweeps < 0 || table == nullptr ||
      smem != smem_bytes(k + (k & 1), threads, rows, slots, sizeof(T),
                         smem_layout) ||
      (!smem_layout && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{in, out, scratch, table, k, k + (k & 1), sweeps, scaled,
               cluster, rows, slots};
  const Kernel kern = kernel_of<T>(smem_layout, split);
  cudaError_t err = set_attributes(kern, cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(count, cluster, threads, smem,
             static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int active_clusters(int cluster, int threads, long long smem,
                    int smem_layout, int split, int* out) {
  const Kernel kern = kernel_of<T>(smem_layout, split);
  cudaError_t err = set_attributes(kern, cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(1, cluster, threads, smem, nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kern, &cfg));
}

}  // namespace

extern "C" {

// Project the (count, k(k+1)/2) row-major packed blocks of `in` onto the
// PSD cone into `out` (another buffer), scaled-vec convention when scaled
// != 0; `sweeps` Jacobi sweeps. The plan's launch: a cluster of `cluster`
// CTAs of `threads` per block, `rows` rows of V per CTA, `slots` block
// slots per CTA (the int32 block `table`: (cluster, slots, 8) where
// `split`, A's slots split over the cluster; else (1, slots, 8), the whole
// of A in each CTA), A and V in shared memory (`smem_layout`, `smem`
// dynamic bytes) or in `scratch` (count slices of
// totsu_psd_jacobi_scratch_elems). Returns a cudaError_t.
int totsu_psd_jacobi_f32(const float* in, float* out, float* scratch,
                         const int* table, int k, int count, int sweeps,
                         int scaled, int cluster, int threads, int rows,
                         int slots, int smem_layout, int split,
                         long long smem, void* stream) {
  return launch<float>(in, out, scratch, table, k, count, sweeps, scaled,
                       cluster, threads, rows, slots, smem_layout, split,
                       smem, stream);
}

int totsu_psd_jacobi_f64(const double* in, double* out, double* scratch,
                         const int* table, int k, int count, int sweeps,
                         int scaled, int cluster, int threads, int rows,
                         int slots, int smem_layout, int split,
                         long long smem, void* stream) {
  return launch<double>(in, out, scratch, table, k, count, sweeps, scaled,
                        cluster, threads, rows, slots, smem_layout, split,
                        smem, stream);
}

// The dynamic shared memory bytes and the global scratch elements per
// block of a layout (to check the wrapper's plan against the kernel's).
long long totsu_psd_jacobi_smem_bytes(int kp, int threads, int rows,
                                      int slots, int elem, int smem_layout) {
  return smem_bytes(kp, threads, rows, slots, elem, smem_layout);
}

long long totsu_psd_jacobi_scratch_elems(int kp, int threads, int rows,
                                         int slots, int elem) {
  return scratch_elems(kp, threads, rows, slots, elem);
}

// How many clusters of the layout the card can hold at once
// (cudaOccupancyMaxActiveClusters) into *out; returns a cudaError_t.
int totsu_psd_jacobi_active_clusters(int elem, int cluster, int threads,
                                     long long smem, int smem_layout,
                                     int split, int* out) {
  *out = 0;
  return elem == 4 ? active_clusters<float>(cluster, threads, smem,
                                            smem_layout, split, out)
                   : active_clusters<double>(cluster, threads, smem,
                                             smem_layout, split, out);
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
