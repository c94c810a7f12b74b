// K7 anneal: simulated-annealing chains over single-bit flips of a delete-set.
//
// Replaces: karpenter_tpu/models/consolidation_model.py `anneal_chains`
// (:103), whose chain body evaluates `_objective` (:69-99) once per step
// (also sharded by parallel/sharded.anneal_sharded, :312).
//
// Per chain c, from x = x0[c] with s = objective(x), for i = 0..S-1:
//   x2 = x with bit flips[c, i] flipped, s2 = objective(x2),
//   temp = max(0.02, 1 - i/S) * (|s| * 0.1 + 1e-3),
//   accept when s2 >= s or u[c, i] < exp(clip((s2 - s) / temp, -50, 0)),
//   and keep the best (x, s) seen (strictly better only).
// objective(x): the displaced mass must fit the slack of kept nodes that are
// compatible with some deleted node (pod_compat[j, i] = 1) and can host one
// average displaced pod, plus at most one replacement row (the cheapest
// whose allocatable covers the shortfall); score = price saved - replacement
// - churn_weight * cost, or -BIG when no row covers it.
//
// What bounds it on an H100: the latency of each chain's 512 dependent
// steps. The bytes (the dense compatibility matrix read once, 268 MB at
// Np = 8192) take ~0.08 ms at the H100 SXM's 3.35 TB/s (700 W); a step's
// arithmetic is a few thousand operations.
//
// Design. Two launches per call:
// 1. `pack_kernel`, once per call: one read of the dense 0/1 matrix packs it
//    into bit rows by host j (`hostbits`, bit i of row j = pod_compat[j, i])
//    and by deleted node i (`delbits`, bit j of row i), 8 MB each at
//    Np = 8192 (L2-resident); it raises a flag on any entry other than 0 or 1
//    and on a flip outside [0, Np), and marks the replacement rows that no
//    other row dominates (`row_keep`: no other row is at most as expensive
//    and at least as large in every resource, ties to the lowest index). The
//    cheapest fitting row is always among those (36 of 2048 rows at the
//    5000-node fleet), so the per-step minimum over them is the reference's.
// 2. `anneal_kernel`, one block per chain (up to 16 warps), exits at once on
//    a raised flag. Its state lives in one arena sized from the problem:
//    shared memory where it fits, else a slice of a global scratch per chain
//    behind the same accessors.
//    - The sums add in XLA:CPU's order: windows of 32 consecutive terms, each
//      in order from 0, then the window sums the same way (`xla_order.cuh`).
//      The kernel keeps every window sum. A flip of node f changes one window
//      of the deleted set's R + 3 series (tot1): warp 0 re-adds that window
//      from its 32 terms and the window sums above it, in the same order.
//      The usable slack's R series (tot2) change only in windows whose 32-bit
//      usable mask changed: those are re-added from the same terms in the
//      same order, and warp 0 re-adds the levels above. Each recomputed
//      window sum is the sum of the same float32 terms in the same order as
//      a full `xla_sums` over all Np, so every total, and the score, is
//      bit-equal to it.
//    - The masks are word operations, one lane per window (warp k owns the
//      chunks of 32 windows k, k + warps, ...): kept bits from x; "some
//      compatible node deleted" from the per-node counts, kept as bit planes
//      (built once from `hostbits`: popcount of row n AND the x bits) with
//      their positive and at-least-2 words, so the flipped node's `delbits`
//      row moves them without a count per lane; and each window's "slack
//      covers avg_pod" mask, cached with the interval of avg_pod in every
//      resource for which it holds. A window is re-evaluated (lane = node,
//      its slack read from global memory) only when avg_pod leaves that
//      interval (~0.06 windows of 256 a step at Np = 8192).
//    - A step's proposal is committed or dropped at the start of the next
//      step's mask pass; warp 0 commits its tot1 path at its decision. Two
//      block barriers per step. The next steps' terms and `delbits` rows
//      arrive by cp.async two steps ahead (four buffers).
//    - best_x is rebuilt at the end from x0 and the flips accepted up to the
//      best step, instead of copied at every improvement.
//    savings - cw * cost and |s| * 0.1 + 1e-3 round once as XLA's fused
//    multiply-adds do; the accept test uses expf on float32, as the plain
//    version does on the card. Built with -fmad=false and IEEE division. The
//    common shape (R = 4) has its own build with R fixed at compile time.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "xla_order.cuh"

#define K7_MAX_WARPS 16
#define BIG 3.4e38f
#define K7_SMEM_BUDGET 232448  // dynamic shared memory a block may take (no static part)
#define FULL 0xffffffffu
#define PACK_WARPS 8

// -- the pre-pass -------------------------------------------------------------

// Blocks [0, tile_blocks): one warp per 32 x 32 tile of pod_compat. Blocks
// past them: one warp per replacement row (dominance). Every thread also
// checks a stride of the flips.
__global__ void __launch_bounds__(32 * PACK_WARPS)
pack_kernel(const float* __restrict__ pc, int N, int nW, uint32_t* __restrict__ hostbits,
            uint32_t* __restrict__ delbits, const float* __restrict__ row_alloc,
            const float* __restrict__ row_price, int T, int R, uint8_t* __restrict__ row_keep,
            const int* __restrict__ flips, long long n_flips, int tile_blocks, int* __restrict__ flag) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  for (long long k = gid; k < n_flips; k += nthreads)
    if (flips[k] < 0 || flips[k] >= N) atomicOr(flag, 2);
  if ((int)blockIdx.x < tile_blocks) {
    const long long tile = (long long)blockIdx.x * PACK_WARPS + warp;
    if (tile >= (long long)nW * nW) return;
    const int bj = (int)(tile / nW), bi = (int)(tile % nW);
    const int i = 32 * bi + lane;
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int j = 32 * bj + k;
      v[k] = (j < N && i < N) ? pc[(size_t)j * N + i] : 0.0f;
    }
    uint32_t del = 0, mine = 0;
    bool bad = false;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      bad = bad || (v[k] != 0.0f && v[k] != 1.0f);
      const uint32_t hb = __ballot_sync(FULL, v[k] != 0.0f);
      if (lane == k) mine = hb;
      del |= (v[k] != 0.0f ? 1u : 0u) << k;
    }
    if (__any_sync(FULL, bad) && lane == 0) atomicOr(flag, 1);
    if (32 * bj + lane < N) hostbits[(size_t)(32 * bj + lane) * nW + bi] = mine;
    if (i < N) delbits[(size_t)i * nW + bj] = del;
    return;
  }
  // row t is dropped when another row t2 is at most as expensive and at least
  // as large in every resource, and strictly better somewhere or earlier
  const long long t = (long long)(blockIdx.x - tile_blocks) * PACK_WARPS + warp;
  if (t >= T) return;
  const float pt = row_price[t];
  bool dominated = false;
#pragma unroll 4
  for (int t2 = lane; t2 < T; t2 += 32) {  // no early exit: the loads of later rows overlap
    const float p2 = row_price[t2];
    bool ge = p2 <= pt, strict = p2 < pt || t2 < t;
    for (int r = 0; r < R; ++r) {
      const float a2 = row_alloc[(size_t)t2 * R + r], a = row_alloc[(size_t)t * R + r];
      ge = ge & (a2 >= a);
      strict = strict | (a2 > a);
    }
    dominated = dominated | (ge && strict && t2 != t);
  }
  dominated = __any_sync(FULL, dominated);
  if (lane == 0) row_keep[t] = dominated ? 0 : 1;
}

// -- the chains ---------------------------------------------------------------

// The window-sum levels of one series: level 0 holds the nW window sums of
// 32 terms, each next level the sums of 32 consecutive entries of the one
// below, until at most 32 remain; the total adds the top level in order.
// In memory every window of 32 entries takes 33 words and a series' level
// an odd number of words, so lanes that each add one window, or one series,
// read different banks. At most LV_MAX levels (nW up to 32^5).
#define LV_MAX 5
struct Lv {
  int nlev, total;  // levels, words per series
  // per level: entries, words per series, words per series below (scalars,
  // read through a select, so an index that is not a constant never moves the
  // table to local memory)
  int s0, s1, s2, s3, s4, w0, w1, w2, w3, w4, c0, c1, c2, c3, c4;
  __host__ __device__ __forceinline__ static int pick(int k, int a, int b, int c, int d, int e) {
    return k == 0 ? a : k == 1 ? b : k == 2 ? c : k == 3 ? d : e;
  }
  __host__ __device__ __forceinline__ int size(int k) const { return pick(k, s0, s1, s2, s3, s4); }
  __host__ __device__ __forceinline__ int ss(int k) const { return pick(k, w0, w1, w2, w3, w4); }
  __host__ __device__ __forceinline__ int cum(int k) const { return pick(k, c0, c1, c2, c3, c4); }
};

__host__ __device__ __forceinline__ int pidx(int i) { return i + (i >> 5); }

__host__ __device__ __forceinline__ Lv levels(int nW) {
  Lv L;
  int s = nW, c = 0, sz[LV_MAX], wd[LV_MAX], cm[LV_MAX];
  bool more = true;
  L.nlev = L.total = 0;
#pragma unroll
  for (int k = 0; k < LV_MAX; ++k) {
    sz[k] = more ? s : 0;
    wd[k] = more ? (pidx(s - 1) + 1) | 1 : 0;
    cm[k] = c;
    if (more) {
      L.nlev = k + 1;
      c += wd[k];
      L.total = c;
      more = s > 32;
      s /= 32;
    }
  }
  if (more) L.nlev = 0;  // more than LV_MAX levels: refused
  L.s0 = sz[0], L.s1 = sz[1], L.s2 = sz[2], L.s3 = sz[3], L.s4 = sz[4];
  L.w0 = wd[0], L.w1 = wd[1], L.w2 = wd[2], L.w3 = wd[3], L.w4 = wd[4];
  L.c0 = cm[0], L.c1 = cm[1], L.c2 = cm[2], L.c3 = cm[3], L.c4 = cm[4];
  return L;
}

// Bits of a per-node count of compatible deleted nodes (at most N).
__host__ __device__ __forceinline__ int count_bits(int N) {
  int b = 1;
  while ((N >> b) != 0) ++b;
  return b;
}

// One chain's arena: byte offsets of its arrays from the arena's base.
struct Arena {
  uint32_t xw, xw0, M, Mp, fm, pos, ge2, chg, planes, lo, hi, acc, lv1, tot1, path, ptot1, A2, lv2, tot2, avg, sf,
      tile, ralloc, rprice, misc, chunk;
  // shared-memory build only
  uint32_t terms, u_s, drow_s, flips_s;
  size_t bytes;

  __host__ __device__ __forceinline__ Arena(int N, int R, int T, int S, int nwarps, bool smem) {
    const int nW = (N + 31) / 32, V = R + 3, CH = R < 8 ? R : 8;
    const Lv L = levels(nW);
    size_t o = 0;
    auto take = [&](size_t n) -> uint32_t {
      const uint32_t p = (uint32_t)o;
      o += (n + 15) & ~(size_t)15;
      return p;
    };
    xw = take(4 * (size_t)nW);
    xw0 = take(4 * (size_t)nW);
    M = take(4 * (size_t)nW);
    Mp = take(4 * (size_t)nW);
    fm = take(4 * (size_t)nW);
    pos = take(4 * (size_t)nW);
    ge2 = take(4 * (size_t)nW);
    chg = take(4 * (size_t)((nW + 31) / 32));
    planes = take(4 * (size_t)count_bits(N) * nW);
    lo = take(4 * (size_t)R * nW);
    hi = take(4 * (size_t)R * nW);
    acc = take(4 * (size_t)((S + 31) / 32));
    lv1 = take(4 * (size_t)V * L.total);
    tot1 = take(4 * (size_t)V);
    path = take(4 * (size_t)V * LV_MAX);
    ptot1 = take(4 * (size_t)V);
    A2 = take(4 * (size_t)R * L.ss(0));
    lv2 = take(4 * (size_t)R * L.total);
    tot2 = take(4 * (size_t)R);
    avg = take(4 * (size_t)R);
    sf = take(4 * (size_t)R);
    tile = take(4 * (size_t)nwarps * CH * 33);
    ralloc = take(4 * (size_t)T * R);
    rprice = take(4 * (size_t)T);
    misc = take(16);
    chunk = take(4 * (size_t)((T + 31) / 32));
    terms = u_s = drow_s = flips_s = 0;
    if (smem) {
      terms = take(4 * 4 * (32 * (size_t)R + 3 * 33));
      drow_s = take(4 * 4 * (size_t)nW);
      flips_s = take(4 * (size_t)S);
      u_s = take(4 * (size_t)S);
    }
    bytes = o;
  }
};

extern __shared__ __align__(16) unsigned char k7_smem[];

__host__ __device__ inline int chain_warps(int N) {
  const int nW = (N + 31) / 32;
  return nW < K7_MAX_WARPS ? nW : K7_MAX_WARPS;
}

struct Args {
  const float *price, *cost, *slack, *used, *npods, *row_alloc, *row_price, *u;
  const uint32_t *hostbits, *delbits;
  const uint8_t *row_keep, *x0;
  const int *flips, *flag;
  int N, R, T, S;
  float cw;
  uint8_t* best_x;
  float* best_s;
  unsigned char* gscratch;
};

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// A step's proposal, committed or dropped at the start of the next step's
// phase B (the decision arrives with its first barrier).
struct Pending {
  bool live, accept;
  int f, fdir, buf;
};

// SMEM: the arena is in shared memory. RF: R fixed at compile time (0: read
// at run time).
template <bool SMEM, int RF>
struct Chain {
  const Args a;
  const Arena o;
  const Lv L;
  const int N, R, V, nW, nwarps, c, lane, warp, CH;
  unsigned char* const gbase;  // the global build's arena

  __device__ __forceinline__ Chain(Args a_, const Arena& o_, int nwarps_, unsigned char* gbase_)
      : a(a_), o(o_), L(levels((a_.N + 31) / 32)), N(a_.N), R(RF ? RF : a_.R), V((RF ? RF : a_.R) + 3),
        nW((a_.N + 31) / 32), nwarps(nwarps_), c(blockIdx.x), lane(threadIdx.x & 31), warp(threadIdx.x >> 5),
        CH((RF ? RF : a_.R) < 8 ? (RF ? RF : a_.R) : 8), gbase(gbase_) {}

  // the arena's arrays (shared-memory addresses in the shared-memory build)
  template <class T>
  __device__ __forceinline__ T* at(uint32_t off) const {
    if constexpr (SMEM) return (T*)(k7_smem + off);
    else return (T*)(gbase + off);
  }
#define K7_ARRAY(T, name) \
  __device__ __forceinline__ T* name() const { return at<T>(o.name); }
  K7_ARRAY(uint32_t, xw) K7_ARRAY(uint32_t, xw0) K7_ARRAY(uint32_t, M) K7_ARRAY(uint32_t, Mp)
  K7_ARRAY(uint32_t, fm) K7_ARRAY(uint32_t, pos) K7_ARRAY(uint32_t, ge2) K7_ARRAY(uint32_t, chg)
  K7_ARRAY(uint32_t, planes) K7_ARRAY(float, lo) K7_ARRAY(float, hi) K7_ARRAY(uint32_t, acc) K7_ARRAY(float, lv1)
  K7_ARRAY(float, tot1) K7_ARRAY(float, path) K7_ARRAY(float, ptot1) K7_ARRAY(float, A2) K7_ARRAY(float, lv2)
  K7_ARRAY(float, tot2) K7_ARRAY(float, avg) K7_ARRAY(float, sf) K7_ARRAY(float, tile) K7_ARRAY(float, ralloc)
  K7_ARRAY(float, rprice) K7_ARRAY(int, misc) K7_ARRAY(int, chunk) K7_ARRAY(float, terms) K7_ARRAY(float, u_s)
  K7_ARRAY(uint32_t, drow_s) K7_ARRAY(int, flips_s)
#undef K7_ARRAY

  // level k of series v of a level array of VV series
  __device__ __forceinline__ float* lvp(float* base, int VV, int k, int v) const {
    return base + (size_t)VV * L.cum(k) + (size_t)v * L.ss(k);
  }
  __device__ __forceinline__ float slack(int n, int r) const { return a.slack[(size_t)n * R + r]; }
  __device__ __forceinline__ float avg_at(const float* avg_r, int r) const {
    if constexpr (RF > 0) return avg_r[r];
    else return avg()[r];
  }
  __device__ __forceinline__ int flip(int i) const {
    if constexpr (SMEM) return flips_s()[i];
    else return a.flips[(size_t)c * a.S + i];
  }
  __device__ __forceinline__ float uni(int i) const {
    if constexpr (SMEM) return u_s()[i];
    else return a.u[(size_t)c * a.S + i];
  }
  __device__ __forceinline__ const uint32_t* drow(int f, int buf) const {
    if constexpr (SMEM) return drow_s() + (size_t)buf * nW;
    else return a.delbits + (size_t)f * nW;
  }

  // The upper levels and totals of the VV series of `lv` whose level 0 is
  // filled, by `nth` threads (index t), `sync` between levels.
  template <class Sync>
  __device__ __forceinline__ void upper_levels(float* lv, int VV, float* tot, int t, int nth, Sync sync) const {
    for (int k = 1; k < L.nlev; ++k) {
      const int s = L.size(k);
      for (int task = t; task < VV * s; task += nth) {
        const int v = task / s, w = task - v * s;
        const float* p = lvp(lv, VV, k - 1, v) + 33 * w;
        float sum = 0.0f;
#pragma unroll 8
        for (int q = 0; q < 32; ++q) sum = sum + p[q];
        lvp(lv, VV, k, v)[pidx(w)] = sum;
      }
      sync();
    }
    const int top = L.nlev - 1, s = L.size(top);
    for (int v = t; v < VV; v += nth) {
      const float* p = lvp(lv, VV, top, v);
      float sum = 0.0f;
      for (int q = 0; q < s; ++q) sum = sum + p[q];
      tot[v] = sum;
    }
    sync();
  }

  // cp.async of step i's terms (warp 0) and delbits row (the last warp) into
  // buffer i % 4, two steps ahead (the step before keeps its delbits row for
  // its commit); the terms of nodes past N are zero. One group per call
  // (empty past the last step), so waiting for all but the newest group
  // completes the next step's.
  __device__ __forceinline__ void prefetch(int i, bool terms_part, bool drow_part) const {
    if constexpr (SMEM) {
      const int f = i < a.S ? flip(i) : 0, w = f >> 5, buf = i % 4;
      if (terms_part && i < a.S) {
        float* t = terms() + (size_t)buf * (32 * R + 3 * 33);
        const int k_hi = min(32, N - 32 * w);
        for (int e = lane; e < 32 * R; e += 32) {
          if (e / R < k_hi) __pipeline_memcpy_async(t + e, a.used + (size_t)32 * w * R + e, 4);
          else t[e] = 0.0f;
        }
#pragma unroll
        for (int which = 0; which < 3; ++which) {
          const float* src = which == 0 ? a.npods : (which == 1 ? a.price : a.cost);
          float* d = t + 32 * R + 33 * which + lane;
          if (lane < k_hi) __pipeline_memcpy_async(d, src + 32 * w + lane, 4);
          else *d = 0.0f;
        }
      }
      if (drow_part && i < a.S) {
        uint32_t* d = drow_s() + (size_t)buf * nW;
        for (int q = lane; q < nW; q += 32) __pipeline_memcpy_async(d + q, a.delbits + (size_t)f * nW + q, 4);
      }
      __pipeline_commit();
    }
  }

  // Phase A (warp 0): the proposal's tot1 with window wf re-added and the
  // levels above it, then avg_pod. f < 0: the committed totals.
  __device__ __forceinline__ void phase_a(int f, int buf) const {
    if (f >= 0) {
      const int wf = f >> 5;
      const uint32_t xb = xw0()[wf] ^ (1u << (f & 31));
      for (int v = lane; v < V; v += 32) {
        float val = 0.0f;
        if constexpr (SMEM) {
          const float* t = terms() + (size_t)buf * (32 * R + 3 * 33);
          const float* tp = v < R ? t + v : t + 32 * R + 33 * (v - R);
          const int ts = v < R ? R : 1;
#pragma unroll 8
          for (int k = 0; k < 32; ++k) val = val + tp[k * ts] * (((xb >> k) & 1) ? 1.0f : 0.0f);
        } else {
          for (int k = 0; k < 32 && 32 * wf + k < N; ++k) {
            const int n = 32 * wf + k;
            const float tv = v < R ? a.used[(size_t)n * R + v] : (v == R ? a.npods[n] : (v == R + 1 ? a.price[n] : a.cost[n]));
            val = val + tv * (((xb >> k) & 1) ? 1.0f : 0.0f);
          }
        }
        path()[v] = val;
        int idx = wf;
        for (int l = 0; l + 1 < L.nlev; ++l) {  // the next level's entry over idx's window of 32
          const int base = idx & ~31;
          const float* p = lvp(lv1(), V, l, v) + pidx(base);
          float s = 0.0f;
#pragma unroll 8
          for (int q = 0; q < 32; ++q) s = s + (base + q == idx ? val : p[q]);
          val = s;
          idx >>= 5;
          path()[(l + 1) * V + v] = val;
        }
        const int top = L.nlev - 1, n = L.size(top);  // the total: the top level in order
        const float* src = lvp(lv1(), V, top, v);
        float s = 0.0f;
        for (int q = 0; q < n; ++q) s = s + (q == idx ? val : src[q]);
        ptot1()[v] = s;
      }
    } else {
      for (int v = lane; v < V; v += 32) ptot1()[v] = tot1()[v];
    }
    __syncwarp();
    for (int r = lane; r < R; r += 32) avg()[r] = ptot1()[r] / fmaxf(ptot1()[R], 1.0f);
  }

  // Phase B (the warp of each chunk of 32 windows, lane = window): the
  // proposal's usable mask of each window from words: kept bits, the counts'
  // positive bits moved by the flipped node's delbits row, and the cached
  // fits mask where avg_pod stays inside the window's interval (lo, hi] in
  // every resource, else the window re-evaluated (lane = node). Windows whose
  // mask changed (all with `force`) get their tot2 window sums in lv2's
  // level 0. Returns fdir, the change of the counts where delbits[f] is set.
  __device__ __forceinline__ int phase_b(int f, int buf, bool force, const Pending& pd) const {
    const int fdir = f < 0 ? 0 : (((xw0()[f >> 5] >> (f & 31)) & 1) ? -1 : 1);
    const uint32_t* dr = f < 0 ? nullptr : drow(f, buf);
    float avg_r[RF > 0 ? RF : 1];
    if constexpr (RF > 0) {
#pragma unroll
      for (int r = 0; r < RF; ++r) avg_r[r] = avg()[r];
    }
    for (int ci = warp; ci < (nW + 31) / 32; ci += nwarps) {
      const int w = 32 * ci + lane;
      const bool vw = w < nW;
      if (pd.live) commit(ci, pd);
      uint32_t keep = 0, posp = 0, full = 0;
      bool stale = false;
      if (vw) {
        uint32_t xb = xw()[w];
        if (f >= 0 && (f >> 5) == w) xb ^= 1u << (f & 31);
        const int left = N - 32 * w;
        keep = ~xb & (left >= 32 ? FULL : (1u << left) - 1);
        posp = pos()[w];
        if (dr) {
          const uint32_t d = dr[w];
          posp = fdir > 0 ? (posp | d) : (posp & ~(d & ~ge2()[w]));
        }
        stale = force;
#pragma unroll 4
        for (int r = 0; r < R; ++r) {
          const float av = avg_at(avg_r, r);
          stale = stale | !(lo()[(size_t)r * nW + w] < av && av <= hi()[(size_t)r * nW + w]);
        }
        full = fm()[w] & keep & posp;
      }
      uint32_t sm = __ballot_sync(FULL, vw && stale);
      for (; sm; sm &= sm - 1) {
        const int b = __ffs(sm) - 1, ws = 32 * ci + b, n = 32 * ws + lane;
        const bool vn = n < N;
        bool fits = vn;
#pragma unroll 4
        for (int r = 0; r < R; ++r) {
          const float v = vn ? slack(n, r) : 0.0f, av = avg_at(avg_r, r);
          const bool pass = vn && v >= av;
          fits = fits & pass;
          float l = vn && v < av ? v : -INFINITY, h = pass ? v : INFINITY;
          for (int o = 16; o > 0; o >>= 1) {
            l = fmaxf(l, __shfl_xor_sync(FULL, l, o));
            h = fminf(h, __shfl_xor_sync(FULL, h, o));
          }
          if (lane == 0) {
            lo()[(size_t)r * nW + ws] = l;
            hi()[(size_t)r * nW + ws] = h;
          }
        }
        const uint32_t fmw = __ballot_sync(FULL, fits);
        if (lane == 0) fm()[ws] = fmw;
        if (lane == b) full = fmw & keep & posp;
      }
      const bool changed = vw && (force || full != M()[w]);
      if (vw) Mp()[w] = full;
      const uint32_t cm = __ballot_sync(FULL, changed);
      if (lane == 0) chg()[ci] = cm;
      for (uint32_t m = cm; m; m &= m - 1) {  // lane = node
        const int b = __ffs(m) - 1, ws = 32 * ci + b, n = 32 * ws + lane;
        const uint32_t mask = __shfl_sync(FULL, full, b);
        float* tl = tile() + (size_t)warp * CH * 33;
        const float wt = ((mask >> lane) & 1) ? 1.0f : 0.0f;
        for (int r0 = 0; r0 < R; r0 += CH) {
          const int nr = min(CH, R - r0);
          for (int j = 0; j < nr; ++j) tl[j * 33 + lane] = n < N ? slack(n, r0 + j) * wt : 0.0f;
          __syncwarp();
          if (lane < nr) {
            float sum = 0.0f;
#pragma unroll 8
            for (int q = 0; q < 32; ++q) sum = sum + tl[lane * 33 + q];
            lvp(lv2(), R, 0, r0 + lane)[pidx(ws)] = sum;
          }
          __syncwarp();
        }
      }
    }
    return fdir;
  }

  // Phase C (warp 0): tot2, the shortfall, the cheapest fitting kept row and
  // the proposal's score (every lane returns it).
  __device__ __forceinline__ float phase_c() const {
    upper_levels(lv2(), R, tot2(), lane, 32, []() { __syncwarp(); });
    bool need = false;
    for (int r = lane; r < R; r += 32) {
      const float s = fmaxf(ptot1()[r] - tot2()[r], 0.0f);
      sf()[r] = s;
      need = need || s > 0.0f;
    }
    const bool needs = __any_sync(FULL, need);
    __syncwarp();
    float b = BIG;
    if (needs) {
      float best = INFINITY;
      const int K = misc()[0];
      for (int k = lane; k < K; k += 32) {
        bool fits = true;
        if constexpr (RF > 0) {
#pragma unroll
          for (int r = 0; r < RF; ++r) fits = fits & (ralloc()[(size_t)r * a.T + k] >= sf()[r]);
        } else {
          for (int r = 0; r < R; ++r) fits = fits & (ralloc()[(size_t)r * a.T + k] >= sf()[r]);
        }
        best = fminf(best, fits ? rprice()[k] : BIG);
      }
      b = warp_min(best);
    }
    const float savings = ptot1()[R + 1] - (needs ? b : 0.0f);
    return (!needs || b < BIG) ? __fmaf_rn(-a.cw, ptot1()[R + 2], savings) : -BIG;
  }

  // The previous step's commit or drop, for chunk ci (its warp, lane =
  // window), at the start of this step's phase B. On accept the counts of
  // the flipped node's compatible hosts move by fdir, bit-sliced: one word
  // per bit plane.
  __device__ __forceinline__ void commit(int ci, const Pending& pd) const {
    const int w = 32 * ci + lane, B = count_bits(N);
    const uint32_t cm = chg()[ci];
    if (w < nW && pd.accept) {
      uint32_t d = pd.f >= 0 ? drow(pd.f, pd.buf)[w] : 0u;
      if (d) {
        uint32_t* P = planes() + w;
        uint32_t any = 0, any2 = 0;
        // add (fdir > 0) or subtract d, a carry or borrow per bit; up to 16
        // planes (counts below 65536) unrolled, so the loads overlap
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          if (b < B) {
            const uint32_t p = P[(size_t)b * nW], np = p ^ d;
            d = pd.fdir > 0 ? (p & d) : (~p & d);
            P[(size_t)b * nW] = np;
            any |= np;
            if (b) any2 |= np;
          }
        }
        for (int b = 16; b < B; ++b) {
          const uint32_t p = P[(size_t)b * nW], np = p ^ d;
          d = pd.fdir > 0 ? (p & d) : (~p & d);
          P[(size_t)b * nW] = np;
          any |= np;
          any2 |= np;
        }
        pos()[w] = any;
        ge2()[w] = any2;
      }
      if ((cm >> lane) & 1) M()[w] = Mp()[w];
      if (pd.f >= 0 && (pd.f >> 5) == w) xw()[w] ^= 1u << (pd.f & 31);
    }
    for (uint32_t m = cm; m; m &= m - 1) {
      const int ws = 32 * ci + __ffs(m) - 1;
      for (int r = lane; r < R; r += 32) {
        float* p = lvp(lv2(), R, 0, r) + pidx(ws);
        float* q = A2() + (size_t)r * L.ss(0) + pidx(ws);
        if (pd.accept) *q = *p;
        else *p = *q;
      }
    }
    __syncwarp();
  }

  // Warp 0 on accept: the flipped window's tot1 path and warp 0's x bits.
  __device__ __forceinline__ void commit_tot1(int f) const {
    const int wf = f >> 5;
    for (int v = lane; v < V; v += 32) {
      int idx = wf;
      for (int l = 0; l < L.nlev; ++l, idx >>= 5) lvp(lv1(), V, l, v)[pidx(idx)] = path()[l * V + v];
      tot1()[v] = ptot1()[v];
    }
    if (lane == 0) xw0()[wf] ^= 1u << (f & 31);
    __syncwarp();
  }

  __device__ __forceinline__ void run() {
    const int tid = threadIdx.x, nth = blockDim.x, S = a.S, T = a.T;
    if (*a.flag != 0) return;  // pod_compat not 0/1 or a flip out of range: the wrapper raises
    // x0 as bits; the kept rows, compacted; the chain's streams and the slack in shared memory
    for (int w = warp; w < nW; w += nwarps) {
      const int n = 32 * w + lane;
      const uint32_t b = __ballot_sync(FULL, n < N && a.x0[(size_t)c * N + n] != 0);
      if (lane == 0) {
        xw()[w] = xw0()[w] = b;
        M()[w] = 0;
      }
    }
    for (int k = tid; k < (S + 31) / 32; k += nth) acc()[k] = 0;
    for (int t = tid; t < ((T + 31) & ~31); t += nth) {
      const uint32_t b = __ballot_sync(FULL, t < T && a.row_keep[t] != 0);
      if (lane == 0) chunk()[t >> 5] = __popc(b);
    }
    if constexpr (SMEM) {
      for (int k = tid; k < S; k += nth) {
        flips_s()[k] = a.flips[(size_t)c * S + k];
        u_s()[k] = a.u[(size_t)c * S + k];
      }
    }
    __syncthreads();
    for (int t = tid; t < ((T + 31) & ~31); t += nth) {
      const bool keep = t < T && a.row_keep[t] != 0;
      const uint32_t b = __ballot_sync(FULL, keep);
      int pos = __popc(b & ((1u << lane) - 1));
      for (int k = 0; k < (t >> 5); ++k) pos += chunk()[k];
      if (keep) {
        for (int r = 0; r < R; ++r) ralloc()[(size_t)r * T + pos] = a.row_alloc[(size_t)t * R + r];
        rprice()[pos] = a.row_price[t];
      }
    }
    if (tid == 0) {
      int K = 0;
      for (int k = 0; k < (T + 31) / 32; ++k) K += chunk()[k];
      misc()[0] = K;
    }
    for (int i = 0; i < 2; ++i) {  // steps 0 and 1
      if (warp == 0) prefetch(i, true, nwarps == 1);
      if (warp == nwarps - 1 && nwarps > 1) prefetch(i, false, true);
    }
    // the count of node n = popcount(hostbits row n AND x), lane = node, as
    // bit planes per window, with their positive and at-least-2 words
    const int B = count_bits(N);
    for (int w = warp; w < nW; w += nwarps) {
      int cv = 0;  // lane k ends with node 32 w + k's count
      for (int k = 0; k < 32; k += 4) {  // four rows at a time, read coalesced, each summed over the warp
        unsigned part[4] = {0, 0, 0, 0};
        for (int q = lane; q < nW; q += 32) {
          const uint32_t xq = xw()[q];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (32 * w + k + u < N) part[u] += __popc(a.hostbits[(size_t)(32 * w + k + u) * nW + q] & xq);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int sum = (int)__reduce_add_sync(FULL, part[u]);
          if (lane == k + u) cv = sum;
        }
      }
      uint32_t any = 0, any2 = 0;
      for (int b = 0; b < B; ++b) {
        const uint32_t pb = __ballot_sync(FULL, (cv >> b) & 1);
        if (lane == 0) planes()[(size_t)b * nW + w] = pb;
        any |= pb;
        if (b) any2 |= pb;
      }
      if (lane == 0) {
        pos()[w] = any;
        ge2()[w] = any2;
      }
    }
    // tot1 of x0: every window, then the levels above
    for (int task = tid; task < V * nW; task += nth) {
      const int v = task / nW, w = task - v * nW;
      const uint32_t xb = xw()[w];
      float s = 0.0f;
      for (int k = 0; k < 32; ++k) {
        const int n = 32 * w + k;
        if (n >= N) break;
        const float tv = v < R ? a.used[(size_t)n * R + v] : (v == R ? a.npods[n] : (v == R + 1 ? a.price[n] : a.cost[n]));
        s = s + tv * (((xb >> k) & 1) ? 1.0f : 0.0f);
      }
      lvp(lv1(), V, 0, v)[pidx(w)] = s;
    }
    __syncthreads();
    upper_levels(lv1(), V, tot1(), tid, nth, []() { __syncthreads(); });

    if (warp == 0 || warp == nwarps - 1) __pipeline_wait_prior(1);  // step 0's buffers
    __syncthreads();

    // step -1 scores x0 (every window's usable mask and sums, committed);
    // steps 0.. propose flips[i]
    float s = 0.0f, bs = 0.0f;
    int bi = -1;
    Pending pd{false, false, -1, 0, 0};
    for (int i = -1; i < S; ++i) {
      const bool init = i < 0;
      const int f = init ? -1 : flip(i), buf = init ? 0 : i % 4;
      if (warp == 0) {
        __syncwarp();
        phase_a(f, buf);
      }
      __syncthreads();  // B1: avg_pod, the last decision, the step's delbits row
      if (!init) {
        if (warp == 0) prefetch(i + 2, true, nwarps == 1);
        if (warp == nwarps - 1 && nwarps > 1) prefetch(i + 2, false, true);
      }
      if (pd.live) pd.accept = misc()[1] != 0;
      const int fdir = phase_b(f, buf, init, pd);
      __syncthreads();  // B2: every window's proposal sums
      if (warp == 0) {
        const float s2 = phase_c();
        bool accept = true;
        if (!init) {
          const float frac = fmaxf(0.02f, 1.0f - (float)i / (float)S);
          const float temp = frac * __fmaf_rn(fabsf(s), 0.1f, 1e-3f);
          const float z = fminf(fmaxf((s2 - s) / temp, -50.0f), 0.0f);
          accept = (s2 >= s) || (uni(i) < expf(z));
        }
        if (lane == 0) misc()[1] = accept ? 1 : 0;
        if (init) {
          s = bs = s2;
        } else if (accept) {
          s = s2;
          if (s > bs) {
            bs = s;
            bi = i;
          }
          if (lane == 0) acc()[i >> 5] |= 1u << (i & 31);
          commit_tot1(f);
        }
      }
      pd = Pending{true, false, f, fdir, buf};  // committed or dropped in the next step's phase B
      if (!init && (warp == 0 || warp == nwarps - 1)) __pipeline_wait_prior(1);  // step i + 1's buffers
    }
    // best_x = x0 with the flips accepted up to the best step
    if (warp == 0 && lane == 0) misc()[2] = bi;
    __syncthreads();
    const int best_i = misc()[2];
    for (int w = warp; w < nW; w += nwarps) {
      const int n = 32 * w + lane;
      const uint32_t b = __ballot_sync(FULL, n < N && a.x0[(size_t)c * N + n] != 0);
      if (lane == 0) Mp()[w] = b;
    }
    __syncthreads();
    for (int k = tid; k <= best_i; k += nth)
      if ((acc()[k >> 5] >> (k & 31)) & 1) {
        const int f = flip(k);
        atomicXor(&Mp()[f >> 5], 1u << (f & 31));
      }
    __syncthreads();
    for (int n = tid; n < N; n += nth) a.best_x[(size_t)c * N + n] = (Mp()[n >> 5] >> (n & 31)) & 1;
    if (tid == 0) a.best_s[c] = bs;
  }
};

template <bool SMEM, int RF>
__global__ void __launch_bounds__(32 * K7_MAX_WARPS, 1) anneal_kernel(Args a) {
  const int nwarps = blockDim.x >> 5;
  const Arena o(a.N, a.R, a.T, a.S, nwarps, SMEM);
  Chain<SMEM, RF> ch(a, o, nwarps, SMEM ? nullptr : a.gscratch + (size_t)blockIdx.x * o.bytes);
  ch.run();
}

static size_t smem_arena(int N, int R, int T, int S) {
  return Arena(N, R, T, S, chain_warps(N), true).bytes;
}

// flag: [1] int32, zeroed by the caller; hostbits, delbits: [N, nW] words;
// row_keep: [T] bytes
extern "C" int kt_anneal_pack(const void* pc, int N, const void* row_alloc, const void* row_price, int T, int R,
                              const void* flips, long long n_flips, void* hostbits, void* delbits, void* row_keep,
                              void* flag, void* stream) {
  const int nW = (N + 31) / 32;
  const long long tiles = (long long)nW * nW;
  const int tile_blocks = (int)((tiles + PACK_WARPS - 1) / PACK_WARPS);
  const int row_blocks = (T + PACK_WARPS - 1) / PACK_WARPS;
  const int blocks = tile_blocks + row_blocks;
  if (blocks == 0) return 0;
  pack_kernel<<<blocks, 32 * PACK_WARPS, 0, (cudaStream_t)stream>>>(
      (const float*)pc, N, nW, (uint32_t*)hostbits, (uint32_t*)delbits, (const float*)row_alloc,
      (const float*)row_price, T, R, (uint8_t*)row_keep, (const int*)flips, n_flips, tile_blocks, (int*)flag);
  return (int)cudaGetLastError();
}

extern "C" int kt_anneal(const void* price, const void* cost, const void* slack, const void* used, const void* npods,
                         const void* hostbits, const void* delbits, const void* row_alloc, const void* row_price,
                         const void* row_keep, const void* x0, const void* flips, const void* u, const void* flag,
                         int C, int N, int R, int T, int S, float churn_weight, void* best_x, void* best_s,
                         void* gscratch, void* stream) {
  if (!xla_sums_shape_ok(N) || levels((N + 31) / 32).nlev == 0) return (int)cudaErrorInvalidValue;
  if (C == 0 || N == 0) return 0;
  Args a{(const float*)price, (const float*)cost, (const float*)slack, (const float*)used, (const float*)npods,
         (const float*)row_alloc, (const float*)row_price, (const float*)u, (const uint32_t*)hostbits,
         (const uint32_t*)delbits, (const uint8_t*)row_keep, (const uint8_t*)x0, (const int*)flips,
         (const int*)flag, N, R, T, S, churn_weight, (uint8_t*)best_x, (float*)best_s, (unsigned char*)gscratch};
  const int threads = 32 * chain_warps(N);
  // the arena in shared memory where it fits, else in the caller's scratch
  const size_t smem = gscratch ? 0 : smem_arena(N, R, T, S);
  if (smem > K7_SMEM_BUDGET) return (int)cudaErrorInvalidValue;
  // the common shape (R = 4) has R fixed at compile time
  auto kern = gscratch ? anneal_kernel<false, 0> : (R == 4 ? anneal_kernel<true, 4> : anneal_kernel<true, 0>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<C, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// bytes of global scratch the launch needs for C chains: 0 where the arena
// fits in shared memory
extern "C" long long kt_anneal_scratch(int C, int N, int R, int T, int S) {
  if (smem_arena(N, R, T, S) <= K7_SMEM_BUDGET) return 0;
  return (long long)C * (long long)Arena(N, R, T, S, chain_warps(N), false).bytes;
}
