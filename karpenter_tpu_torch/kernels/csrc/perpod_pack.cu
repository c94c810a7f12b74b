// K8 perpod_pack: the per-pod FFD scan, one persistent block in which one
// warp decides each pod.
//
// Replaces: karpenter_tpu/models/scheduler_model.py `_greedy_pack_impl`
// (:507-635; the lax.scan `step` :530-621) with ops/select.py
// `first_true_index` (:10) and `masked_argmin` (:19). K1 computes its
// compatibility and row key for all pods beforehand (`_compat_matrix`
// :503, `row_choose_key` :565).
//
// What bounds it on an H100: not bytes (the pod inputs, K1's [P, Nrows]
// outputs and the carry are ~4 MB at the headline, ~1.2 us at 3.35 TB/s)
// and not arithmetic, but the sequential chain: pod i+1 reads the slot
// state pod i wrote, so the time is the latency of one pod's decision
// times the pods. The design keeps that chain on one warp, in shared
// memory, with no block barrier where it can:
//   - Before the scan every thread packs the state-independent facts of a
//     stride of pods into its record in the scratch: allowed domains,
//     constrained keys and the constrained key's domains as bit sets of nw
//     32-bit words (nw = ceil(max(D, Kd, Q) / 32); a build fixes nw = 1),
//     the request, and the pod's groups by role as compact lists.
//   - Warp 1 copies the next pods' records and K1 compat rows into a ring
//     of NBUF in shared memory with cp.async while warp 0 decides (past
//     the reach warp 0 copies pod i+2 itself while it decides pod i). The
//     record's header (list offsets, flags, the sets' first words, the
//     first RQ requests) is read with 16-byte loads.
//   - The slot state (basis, remaining capacity, domain set, host counts)
//     of the first `tile` slots sits in shared memory, the rest in global
//     memory behind the same accessors; counts_dom and the constants sit in
//     an arena of shared memory (a global spill where it does not fit).
//   - Per pod, warp 0: dom_feasible (spread_ok_of, lanes over the pod's
//     keyed groups, an AND across the warp); the first open slot that fits
//     (lanes over 32 slots at a time, `__ballot_sync` and `__ffs`; up to 64
//     open slots both chunks at once, every load issued before any test,
//     since a single warp's time is its chain of dependent instructions);
//     only when no open slot fits, rank_ok (lanes over
//     ranks) and the masked argmin of the K1 key over the offering rows
//     (lanes over rows, a shuffle butterfly over (value, row, fits));
//     z_star (lanes over domains, two `__reduce_min_sync`); the update of
//     slot j, counts_dom and counts_host (lanes over the pod's groups).
//     The new-slot row feeds only the arms the reference selects when no
//     slot fits (`where(use_slot, ...)`), so skipping it changes no bit.
//   - While open_count <= WARP_REACH warps 2.. wait at one barrier for the
//     whole phase. From the first pod that sees more open slots
//     (open_count only grows) every warp searches chunks c = warp, warp + 8,
//     ... with an early exit once a lower fit is known (`atomicMin` on a
//     word in shared memory), between two block barriers per pod; warp 0
//     decides as before. One build, one code path: the regime is chosen at
//     run time by open_count.
// Bit-parity with the reference: rem_j is one IEEE f32 subtraction (built
// with -fmad=false), int32 sums wrap in unsigned arithmetic, ties go to the
// lowest index everywhere (slots, rows, domains), masked-out rows take the
// value BIG and still win ties below the first fitting row (a winner that
// does not fit means -1, as `masked_argmin`), and z_star is 0 (the NO_ZONE
// sentinel) when every domain costs INF.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define NWARP (NT / 32)
#define FULL 0xffffffffu
#define WARP_REACH 64  // open slots up to which warp 0 searches alone
#define NBUF 8         // pods whose record and compat row a ring in shared memory holds (a power of 2)
#define RQ 8           // a pod's first RQ requests are held in registers
#define INF_I (1 << 30)
#define BIGF 3.4e38f
#define NO_FIT 0x7fffffff
#define SMEM_LIMIT 232448
#define STATIC_SMEM 1024  // bytes kept for the static shared variables

enum { K_DOM_SPREAD = 0, K_HOST_SPREAD = 1, K_HOST_ANTI = 2, K_DOM_ANTI = 3 };

struct PerPodArgs {
  const float* row_alloc;          // [Nrows, R]
  const int* row_pool_rank;        // [Nrows]
  const uint8_t* rank_domset;      // [Q, D]
  const int* dom_key_of;           // [D]
  const int* group_kind;           // [G]
  const int* group_skew;           // [G]
  const int* group_dom_key;        // [G]
  const int* group_min_domains;    // [G]
  const uint8_t* group_registered; // [G, D]
  const float* pod_req;            // [P, R]
  const uint8_t* pod_dom_allowed;  // [P, D]
  const uint8_t* pod_restrict;     // [P, Kd]
  const uint8_t* member;           // [P, G]
  const uint8_t* owner;            // [P, G]
  const uint8_t* compat;           // [P, Nrows]
  const float* choose_key;         // [P, Nrows]
  int* slot_basis;                 // [N]     carry: the initial carry on entry, the final one on exit
  float* slot_rem;                 // [N, R]
  uint8_t* slot_domset;            // [N, D]
  int* slot_rank;                  // [N]
  int* counts_dom;                 // [G, D]
  int* counts_host;                // [G, N]
  int* open_count;                 // [1]
  int* assignment;                 // [P]
  uint32_t* scratch;               // see Layout
  int P, N, Nrows, R, D, G, Q, Kd, n_existing, n_rows_real;
  int nw;  // words of every bit set: ceil(max(D, Kd, Q) / 32), at least 1
};

// a pod's record (4-byte words, each part 16-byte aligned): the start of
// each group list and the end of the last (N_LISTS + 1 offsets into the
// entries) and a word of flags (which lists are not empty); the za, rs and
// kmask bit sets [nw] each; req [R] (f32 bits, at least RQ words); the
// entries (at most 3G: a keyed member is in L_DM and in L_SPREAD or L_ANTI)
enum { L_DM = 0, L_SPREAD, L_ANTI, L_HOST, L_OWN_HS, L_OWN_HA, N_LISTS };
enum { F_DM = 1, F_SPREAD = 2, F_ANTI = 4, F_HOST = 8, F_OWN = 16 };
#define H_SETS 8  // the sets' first word (after the offsets and the flags)

__host__ __device__ inline size_t up4(size_t x) { return (x + 3) & ~(size_t)3; }
__host__ __device__ inline int h_req(int nw) { return H_SETS + (int)up4(3 * (size_t)nw); }
__host__ __device__ inline int h_ent(int nw, int R) { return h_req(nw) + (int)up4(R > RQ ? R : RQ); }

// The arena (constants, counts_dom, the published dom_feasible and rank_ok,
// the rings of records and compat rows, the slot tile) in shared memory
// where its fixed part fits, else in the global scratch with no tile; the
// global scratch holds the domain sets [nw][N] of the slots past the tile,
// the records, then the arena if it spilled. Offsets in 4-byte words, each
// a multiple of 4 (16-byte copies).
struct Layout {
  int nw, rec_words, crow_words, tile;
  size_t keymask, rank_bits, reg_bits, kind, skew, min_dom, counts_dom, dfeas, rank_ok, rec_ring, crow_ring;
  size_t t_basis, t_rem, t_ds, t_ch, arena_words;
  size_t domset, recs, spill, words;
  bool arena_s;
};

__host__ __device__ inline Layout layout_of(int P, int N, int Nrows, int R, int D, int G, int Q, int Kd, int nw) {
  Layout L;
  L.nw = nw;
  L.rec_words = (int)up4(h_ent(nw, R) + 3 * (size_t)G);
  L.crow_words = (int)up4(((size_t)Nrows + 3) / 4);
  size_t o = 0;
  L.keymask = o; o += up4((size_t)Kd * nw);
  L.rank_bits = o; o += up4((size_t)Q * nw);
  L.reg_bits = o; o += up4((size_t)G * nw);
  L.kind = o; o += up4(G);
  L.skew = o; o += up4(G);
  L.min_dom = o; o += up4(G);
  L.counts_dom = o; o += up4((size_t)G * D);
  L.dfeas = o; o += up4(nw);
  L.rank_ok = o; o += up4(nw);
  L.rec_ring = o; o += (size_t)NBUF * L.rec_words;
  L.crow_ring = o; o += (size_t)NBUF * L.crow_words;
  const size_t room = SMEM_LIMIT - STATIC_SMEM;
  L.arena_s = 4 * o <= room;
  size_t tile = 0;
  if (L.arena_s) {
    const size_t per_slot = 4 * (1 + (size_t)R + nw + G);
    tile = (room - 4 * o) / per_slot;
    tile = tile < (size_t)N ? tile & ~(size_t)3 : (size_t)N;
    // the four arrays' padding
    while (tile > 0 && 4 * (o + up4(tile) + up4(tile * R) + up4(tile * nw) + up4(tile * G)) > room)
      tile = tile > 4 ? tile - 4 : 0;
  }
  L.tile = (int)tile;
  L.t_basis = o; o += up4(tile);
  L.t_rem = o; o += up4(tile * R);
  L.t_ds = o; o += up4(tile * nw);
  L.t_ch = o; o += up4(tile * G);
  L.arena_words = o;
  o = 0;
  L.domset = o; o += up4((size_t)nw * N);
  L.recs = o; o += (size_t)P * L.rec_words;
  L.spill = o; o += L.arena_s ? 0 : L.arena_words;
  L.words = o;
  return L;
}

// The scan's tables: the arena's, and the slot state behind accessors that
// read the tile below `tile` and the carry (or the scratch's domain sets)
// above it.
struct Ctx {
  int P, N, Nrows, R, D, G, Q, n_existing, n_rows_real, nw, tile, rec_words, crow_words;
  int hreq, hent;  // a record's request and entry offsets
  uint32_t *keymask, *rank_bits, *reg_bits, *dfeas, *rank_ok, *rec_ring, *crow_ring;
  int *kind, *skew, *min_dom, *counts_dom;
  int* t_basis;
  float* t_rem;
  uint32_t* t_ds;
  int* t_ch;
  const uint32_t* recs;
  uint32_t* g_ds;
  int *g_basis, *g_ch;
  float* g_rem;

  __device__ __forceinline__ uint32_t& ds(int j, int w) const { return *ds_p<false>(j, w); }
  // slot j's state; SH says j is in the tile (the address is then known to
  // be a shared-memory one)
  template <bool SH>
  __device__ __forceinline__ int* basis_p(int j) const {
    return SH || j < tile ? t_basis + j : g_basis + j;
  }
  template <bool SH>
  __device__ __forceinline__ float* rem_p(int j) const {
    return (SH || j < tile ? t_rem : g_rem) + (size_t)j * R;
  }
  template <bool SH>
  __device__ __forceinline__ uint32_t* ds_p(int j, int w) const {
    return SH || j < tile ? t_ds + (size_t)w * tile + j : g_ds + (size_t)w * N + j;
  }
  template <bool SH>
  __device__ __forceinline__ int* ch_p(int g, int j) const {
    return SH || j < tile ? t_ch + (size_t)g * tile + j : g_ch + (size_t)g * N + j;
  }
};

__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ bool bt(const uint32_t* m, int d) { return (m[d >> 5] >> (d & 31)) & 1u; }
__device__ __forceinline__ uint32_t full_word(int n, int w) {
  const int k = n - 32 * w;
  return k >= 32 ? 0xffffffffu : (k <= 0 ? 0u : ((1u << k) - 1u));
}
// word w of row `row` of a [*, n] bool plane
__device__ __forceinline__ uint32_t plane_word(const uint8_t* plane, size_t row, int n, int w) {
  uint32_t m = 0;
  const int lo = 32 * w, hi = min(n, lo + 32);
  for (int x = lo; x < hi; ++x) m |= (uint32_t)(plane[row * n + x] != 0) << (x - lo);
  return m;
}

// (value, index, fits) lexicographic min: ties to the lowest index
__device__ __forceinline__ void argmin_merge(float& v, int& i, int& f, float v2, int i2, int f2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
    f = f2;
  }
}

// A pod's record in shared memory (or in the scratch, when the arena
// spilled), with its list offsets, its sets' first words and its first RQ
// requests in registers.
struct Pod {
  const uint32_t* rec;
  const uint8_t* crow;  // K1's compat row of the pod
  const int* ent;       // the lists' entries
  int off[N_LISTS + 1];
  int nw, flags, hreq;
  uint32_t za0, rs0, km0;  // word 0 of za, rs and kmask (the sets, where nw = 1)
  float rq[RQ];
  __device__ __forceinline__ uint32_t za(int w) const { return rec[H_SETS + w]; }
  __device__ __forceinline__ uint32_t rs(int w) const { return rec[H_SETS + nw + w]; }
  __device__ __forceinline__ uint32_t kmask(int w) const { return rec[H_SETS + 2 * nw + w]; }
  __device__ __forceinline__ float req(int r) const { return __uint_as_float(rec[hreq + r]); }
  // kmask word w, from the register where nw = 1
  template <int NW>
  __device__ __forceinline__ uint32_t km(int w) const {
    return NW == 1 ? km0 : kmask(w);
  }
  __device__ __forceinline__ int len(int l) const { return off[l + 1] - off[l]; }
  __device__ __forceinline__ int at(int l, int t) const { return ent[off[l] + t]; }
};

template <bool SMEM>
__device__ __forceinline__ Pod pod_of(const Ctx& c, const PerPodArgs& a, int i, int nw) {
  Pod p;
  p.nw = nw;
  const int slot = i & (NBUF - 1);
  p.rec = SMEM ? c.rec_ring + slot * c.rec_words : c.recs + (size_t)i * c.rec_words;
  p.crow = SMEM ? reinterpret_cast<const uint8_t*>(c.crow_ring + slot * c.crow_words) : a.compat + (size_t)i * c.Nrows;
  // 16-byte loads of the header, the sets' first words and RQ requests
  const uint4 o0 = reinterpret_cast<const uint4*>(p.rec)[0], o1 = reinterpret_cast<const uint4*>(p.rec)[1];
  p.off[0] = (int)o0.x;
  p.off[1] = (int)o0.y;
  p.off[2] = (int)o0.z;
  p.off[3] = (int)o0.w;
  p.off[4] = (int)o1.x;
  p.off[5] = (int)o1.y;
  p.off[6] = (int)o1.z;
  p.flags = (int)o1.w;
  p.hreq = c.hreq;
  p.ent = reinterpret_cast<const int*>(p.rec + c.hent);
  if (nw == 1) {
    const uint4 z = reinterpret_cast<const uint4*>(p.rec + H_SETS)[0];
    p.za0 = z.x;
    p.rs0 = z.y;
    p.km0 = z.z;
  } else {
    p.za0 = p.za(0);
    p.rs0 = p.rs(0);
    p.km0 = p.kmask(0);
  }
  const float4* q = reinterpret_cast<const float4*>(p.rec + c.hreq);
#pragma unroll
  for (int k = 0; k < RQ / 4; ++k) {
    const float4 v = q[k];
    p.rq[4 * k] = v.x;
    p.rq[4 * k + 1] = v.y;
    p.rq[4 * k + 2] = v.z;
    p.rq[4 * k + 3] = v.w;
  }
  return p;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(gmem));
}
// a flag in shared memory between warps: acquire loads, release stores
// (no fence that would wait for the warp's global stores)
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n" : "=r"(v) : "r"((unsigned)__cvta_generic_to_shared(p)) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"((unsigned)__cvta_generic_to_shared(p)), "r"(v) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// one warp: copy pod i's record and compat row into their ring buffers
// (nothing past the last pod, or with `skip`), as one commit group
__device__ __forceinline__ void prefetch(const Ctx& c, const PerPodArgs& a, int i, bool skip = false) {
  const int lane = threadIdx.x & 31;
  if (i < c.P && !skip) {
    const uint32_t* src = c.recs + (size_t)i * c.rec_words;
    uint32_t* dst = c.rec_ring + (i & (NBUF - 1)) * c.rec_words;
#pragma unroll 1
    for (int e = 4 * lane; e < c.rec_words; e += 128) cp_async16(dst + e, src + e);
    const uint8_t* cs = a.compat + (size_t)i * c.Nrows;
    uint8_t* cd = reinterpret_cast<uint8_t*>(c.crow_ring + (i & (NBUF - 1)) * c.crow_words);
    const uintptr_t al = reinterpret_cast<uintptr_t>(cs) | (uintptr_t)c.Nrows;
    if ((al & 15) == 0) {
#pragma unroll 1
      for (int e = 16 * lane; e < c.Nrows; e += 512) cp_async16(cd + e, cs + e);
    } else if ((al & 3) == 0) {
#pragma unroll 1
      for (int e = 4 * lane; e < c.Nrows; e += 128) cp_async4(cd + e, cs + e);
    } else {
#pragma unroll 1
      for (int e = lane; e < c.Nrows; e += 32) cd[e] = cs[e];
    }
  }
  cp_async_commit();
}

// warp 0, at the start of pod i past the reach: pod i + 2 on its way
// (unless the loader brought it: pods below `loaded`), pod i's copies
// landed and visible to the warp
template <bool SMEM>
__device__ __forceinline__ void begin_pod(const Ctx& c, const PerPodArgs& a, int i, int loaded) {
  if (SMEM) {
    prefetch(c, a, i + 2, i + 2 < loaded);
    cp_async_wait<2>();
  }
  __syncwarp();
}

// every restricted key of the pod keeps an allowed domain in set s (s(w):
// its word w)
template <int NW, class S>
__device__ __forceinline__ bool perkey_ok(const Ctx& c, const Pod& p, const S& s) {
  if (NW == 1) {
    const uint32_t zs = s(0) & p.za0;
    bool ok = true;
#pragma unroll 1
    for (uint32_t k = p.rs0; k; k &= k - 1) ok &= (zs & c.keymask[__ffs(k) - 1]) != 0;
    return ok;
  }
  const int nw = NW > 0 ? NW : c.nw;
#pragma unroll 1
  for (int w0 = 0; w0 < nw; ++w0) {
#pragma unroll 1
    for (uint32_t k = p.rs(w0); k; k &= k - 1) {
      const uint32_t* km = c.keymask + (size_t)(w0 * 32 + __ffs(k) - 1) * nw;
      bool hit = false;
      for (int w = 0; w < nw && !hit; ++w) hit = (s(w) & p.za(w) & km[w]) != 0;
      if (!hit) return false;
    }
  }
  return true;
}

// warp 0: the pod's dom_feasible (spread_ok_of over its keyed groups, from
// the current counts_dom). Returns word 0 in every lane (the whole set
// where nw = 1); the words go to the arena for the other warps with
// `publish`, and always where nw is read at run time.
template <int NW>
__device__ __forceinline__ uint32_t dom_feasible(const Ctx& c, const Pod& p, bool publish) {
  const int lane = threadIdx.x & 31, nw = NW > 0 ? NW : c.nw, D = c.D;
  const int n_dm = p.len(L_DM);
  const bool store = publish || NW != 1;
  if (!(p.flags & F_DM)) {
    if (store) {
#pragma unroll 1
      for (int w = lane; w < nw; w += 32) c.dfeas[w] = p.za(w);
      __syncwarp();
    }
    return p.za0;
  }
  uint32_t w0 = 0;
#pragma unroll 1
  for (int w = 0; w < nw; ++w) {
    uint32_t acc = full_word(D, w);
#pragma unroll 1
    for (int t = lane; t < n_dm; t += 32) {
      const int g = p.at(L_DM, t);
      const int* cd = c.counts_dom + (size_t)g * D;
      const uint32_t* reg = c.reg_bits + (size_t)g * nw;
      int zmin = INF_I, nzr = 0;
#pragma unroll 1
      for (int d = 0; d < D; ++d)
        if ((p.za(d >> 5) & reg[d >> 5]) >> (d & 31) & 1u) {
          zmin = min(zmin, cd[d]);
          ++nzr;
        }
      if (zmin >= INF_I) zmin = 0;
      if (c.min_dom[g] > 0 && nzr < c.min_dom[g]) zmin = 0;
      const bool anti = c.kind[g] == K_DOM_ANTI;
      const int skew = c.skew[g];
      uint32_t okm = 0;
#pragma unroll 1
      for (int d = 32 * w; d < min(D, 32 * w + 32); ++d) {
        const bool o = anti ? cd[d] == 0 : (int)((unsigned)cd[d] + 1u - (unsigned)zmin) <= skew;
        okm |= (uint32_t)o << (d - 32 * w);
      }
      acc &= okm & reg[w];
    }
    const uint32_t word = p.za(w) & __reduce_and_sync(FULL, acc);
    if (w == 0) w0 = word;
    if (store && lane == 0) c.dfeas[w] = word;
  }
  if (store) __syncwarp();
  return w0;
}

// whether slot j fits the pod where `valid` (dfe0: dom_feasible's word 0;
// SH: slot j is in the tile). Where the word count is 1 every load is
// issued before any test (no early exit), so two calls interleave.
template <int NW, bool SH>
__device__ __forceinline__ bool slot_fits(const Ctx& c, const Pod& p, uint32_t dfe0, int j, bool valid) {
  const int jj = valid ? j : 0;
  const int b = *c.basis_p<SH>(jj);
  const float* rem = c.rem_p<SH>(jj);
  const uint32_t s0 = *c.ds_p<SH>(jj, 0);
  bool f = valid & (b >= 0);
#pragma unroll
  for (int r = 0; r < RQ; ++r)
    if (r < c.R) f &= p.rq[r] <= rem[r];
#pragma unroll 1
  for (int r = RQ; r < c.R; ++r) f &= p.req(r) <= rem[r];
  if (p.flags & F_OWN) {
#pragma unroll 1
    for (int t = 0; t < p.len(L_OWN_HS); ++t) {
      const int g = p.at(L_OWN_HS, t);
      f &= wrap_add(*c.ch_p<SH>(g, jj), 1) <= c.skew[g];
    }
#pragma unroll 1
    for (int t = 0; t < p.len(L_OWN_HA); ++t) f &= *c.ch_p<SH>(p.at(L_OWN_HA, t), jj) == 0;
  }
  f &= p.crow[min(max(b, 0), c.Nrows - 1)] != 0;
  if (NW == 1) {
    f &= perkey_ok<1>(c, p, [&](int) { return s0; });
    return f & (!(p.flags & F_DM) || (s0 & dfe0) != 0);
  }
  if (!f) return false;
  if (!perkey_ok<NW>(c, p, [&](int w) { return *c.ds_p<SH>(jj, w); })) return false;
  if (!(p.flags & F_DM)) return true;
  bool meets = false;
#pragma unroll 1
  for (int w = 0; w < c.nw && !meets; ++w) meets = (*c.ds_p<SH>(jj, w) & c.dfeas[w]) != 0;
  return meets;
}

// one warp's part of the first-fit search over the open slots: chunks of 32
// slots c0, c0 + step, ...; the lowest fit of the first chunk that has one,
// else NO_FIT. With `fm` (the block's search) a chunk above a fit another
// warp already reported is skipped, and a fit is reported with atomicMin.
template <int NW, bool SH>
__device__ __forceinline__ int search(const Ctx& c, const Pod& p, uint32_t dfe0, int open, int c0, int step,
                                      int* fm) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int ch = c0; 32 * ch < open; ch += step) {
    if (fm) {
      const int known = __shfl_sync(FULL, lane == 0 ? *(volatile int*)fm : 0, 0);
      if (known < 32 * ch) break;
    }
    const int j = 32 * ch + lane;
    const uint32_t m = __ballot_sync(FULL, slot_fits<NW, SH>(c, p, dfe0, j, j < open));
    if (m) {
      const int jj = 32 * ch + __ffs(m) - 1;
      if (fm && lane == 0) atomicMin(fm, jj);
      return jj;
    }
  }
  return NO_FIT;
}

// warp 0 alone (open <= WARP_REACH <= 64): the first fit, both chunks of 32
// slots evaluated at once where the word count is 1
template <int NW, bool SH>
__device__ __forceinline__ int search_warp(const Ctx& c, const Pod& p, uint32_t dfe0, int open) {
  static_assert(WARP_REACH <= 64, "warp 0 searches at most two chunks");
  if (NW != 1) return search<NW, SH>(c, p, dfe0, open, 0, 1, nullptr);
  const int lane = threadIdx.x & 31;
  const bool f0 = slot_fits<NW, SH>(c, p, dfe0, lane, lane < open);
  const bool f1 = open > 32 && slot_fits<NW, SH>(c, p, dfe0, lane + 32, lane + 32 < open);
  const uint32_t m0 = __ballot_sync(FULL, f0), m1 = __ballot_sync(FULL, f1);
  return m0 ? __ffs(m0) - 1 : (m1 ? 31 + __ffs(m1) : NO_FIT);
}

// warp 0, only when no open slot fits: the offering row a new slot opens
// on (the masked argmin of the K1 key), or -1
template <int NW>
__device__ int new_slot_row(const Ctx& c, const PerPodArgs& a, const Pod& p, uint32_t dfe0, int i) {
  const int lane = threadIdx.x & 31, nw = NW > 0 ? NW : c.nw, Q = c.Q;
  const int dm = p.flags & F_DM;
  // rank_ok: the rank's domains meet dom_feasible and keep every restricted key
#pragma unroll 1
  for (int qc = 0; qc < Q; qc += 32) {
    const int q = qc + lane;
    bool ok = false;
    if (q < Q) {
      const uint32_t* rb = c.rank_bits + (size_t)q * nw;
      bool meets = !dm;
#pragma unroll 1
      for (int w = 0; w < nw && !meets; ++w) meets = (rb[w] & (NW == 1 ? dfe0 : c.dfeas[w])) != 0;
      ok = meets && perkey_ok<NW>(c, p, [&](int w) { return rb[w]; });
    }
    const uint32_t word = __ballot_sync(FULL, ok);
    if (lane == 0) c.rank_ok[qc >> 5] = word;
  }
  __syncwarp();
  // rows outside [n_existing, n_rows_real) are masked out: the lowest of
  // them stands for all (value BIG, not fitting)
  float bv = BIGF;
  int bi = NO_FIT, bf = 0;
  if (lane == 0) bi = c.n_existing > 0 ? 0 : (c.n_rows_real < c.Nrows ? c.n_rows_real : NO_FIT);
  const float* key = a.choose_key + (size_t)i * c.Nrows;
#pragma unroll 1
  for (int r = c.n_existing + lane; r < c.n_rows_real; r += 32) {
    bool f = p.crow[r] != 0;
#pragma unroll 1
    for (int k = 0; k < c.R && f; ++k) f = p.req(k) <= a.row_alloc[(size_t)r * c.R + k];
    f = f && bt(c.rank_ok, min(max(a.row_pool_rank[r], 0), Q - 1));
    argmin_merge(bv, bi, bf, f ? key[r] : BIGF, r, f ? 1 : 0);
  }
  for (int o = 16; o; o >>= 1) {
    const float v2 = __shfl_xor_sync(FULL, bv, o);
    const int i2 = __shfl_xor_sync(FULL, bi, o);
    const int f2 = __shfl_xor_sync(FULL, bf, o);
    argmin_merge(bv, bi, bf, v2, i2, f2);
  }
  return bf ? bi : -1;
}

// warp 0: the decision for pod i (its first fit `found`, else a new slot)
// and the update of the slot, counts_dom and counts_host (dfe0: as in
// `search`; SH: every slot this pod can take is in the tile)
template <int NW, bool SH>
__device__ void place(const Ctx& c, const PerPodArgs& a, const Pod& p, uint32_t dfe0, int i, int found, int& open) {
  const int lane = threadIdx.x & 31, nw = NW > 0 ? NW : c.nw, D = c.D;
  const bool use_slot = found != NO_FIT;
  int o_new = -1;
  if (!use_slot && open < c.N) o_new = new_slot_row<NW>(c, a, p, dfe0, i);
  const int j = use_slot ? found : (o_new >= 0 ? open : -1);
  if (lane == 0) a.assignment[i] = j;
  if (j < 0) return;
  const int safe_o = min(max(o_new, 0), c.Nrows - 1);
  const int rank_o = use_slot ? 0 : a.row_pool_rank[safe_o];
  const uint32_t* rbo = c.rank_bits + (size_t)min(max(rank_o, 0), c.Q - 1) * nw;
  const int n_dm = p.len(L_DM);
  const int dm = p.flags & F_DM;
  // the domains this placement can still use (word w; word 0 read once)
  auto cur_of = [&](int w) {
    const uint32_t m = dm ? p.km<NW>(w) : 0u;
    const uint32_t dfe = NW == 1 ? dfe0 : c.dfeas[w];
    return (use_slot ? *c.ds_p<SH>(j, w) : rbo[w]) & ((dfe & m) | (p.za(w) & ~m));
  };
  const uint32_t cur0 = cur_of(0);
  auto cur = [&](int w) { return NW == 1 ? cur0 : cur_of(w); };
  // spread members commit to the least-counted domain of their key: dom_cost
  // per domain (lanes over domains), argmin with ties to the lowest domain
  int z_star = 0;
  if (dm) {
    auto cost_of = [&](int d) {
      if (!((cur(d >> 5) & p.km<NW>(d >> 5)) >> (d & 31) & 1u)) return INF_I;
      unsigned sum = 0;
#pragma unroll 1
      for (int t = 0; t < n_dm; ++t) sum += (unsigned)c.counts_dom[(size_t)p.at(L_DM, t) * D + d];
      return (int)sum;
    };
    int bc = cost_of(0), bd = 0;
#pragma unroll 1
    for (int d = lane; d < D; d += 32) {
      const int cost = cost_of(d);
      if (cost < bc) {
        bc = cost;
        bd = d;
      }
    }
    const int best = __reduce_min_sync(FULL, bc);
    z_star = (int)__reduce_min_sync(FULL, (unsigned)(bc == best ? bd : NO_FIT));
  }
  const bool narrow = dm && (p.flags & F_SPREAD);
  const int n_anti = p.flags & F_ANTI ? p.len(L_ANTI) : 0;
#pragma unroll 1
  for (int w = 0; w < nw; ++w) {
    const uint32_t cw = cur(w), km = p.km<NW>(w);
    const uint32_t zb = (z_star >> 5) == w ? 1u << (z_star & 31) : 0u;
    const uint32_t ns = narrow ? ((km & zb) | (cw & ~km)) & cw : cw;
    __syncwarp();  // every lane has read the slot's word w
    if (lane == 0) *c.ds_p<SH>(j, w) = ns;
    // anti-affinity members block every keyed domain the slot may use
    if (n_anti && (ns & km) >> lane & 1u) {
#pragma unroll 1
      for (int t = 0; t < n_anti; ++t) {
        int* cd = &c.counts_dom[(size_t)p.at(L_ANTI, t) * D + 32 * w + lane];
        *cd = wrap_add(*cd, 1);
      }
    }
  }
  float* rem = c.rem_p<SH>(j);
  auto take = [&](int r) {
    const float base = use_slot ? rem[r] : a.row_alloc[(size_t)safe_o * c.R + r];
    rem[r] = __fsub_rn(base, p.req(r));
  };
  if (lane < c.R) take(lane);
#pragma unroll 1
  for (int r = lane + 32; r < c.R; r += 32) take(r);
  if (!use_slot) {
    if (lane == 0) {
      *c.basis_p<SH>(j) = o_new;
      a.slot_rank[j] = rank_o;
    }
    ++open;
  }
  if (narrow) {
#pragma unroll 1
    for (int t = lane; t < p.len(L_SPREAD); t += 32) {
      int* cd = &c.counts_dom[(size_t)p.at(L_SPREAD, t) * D + z_star];
      *cd = wrap_add(*cd, 1);
    }
  }
  if (p.flags & F_HOST) {
#pragma unroll 1
    for (int t = lane; t < p.len(L_HOST); t += 32) {
      int* h = c.ch_p<SH>(p.at(L_HOST, t), j);
      *h = wrap_add(*h, 1);
    }
  }
  __syncwarp();
}

// NW > 0 fixes the words of every bit set at compile time; SMEM says the
// arena is in shared memory (with the rings and the slot tile); SH1 says
// the tile holds more than WARP_REACH slots, so every slot warp 0 alone
// touches is at a shared-memory address
template <int NW, bool SMEM, bool SH1>
__global__ void __launch_bounds__(NT, 1) perpod_pack_kernel(PerPodArgs a) {
  __shared__ int s_open, s_i0, s_fm, s_ready, s_done, s_stop;
  extern __shared__ __align__(16) uint32_t dyn[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.R, D = a.D, G = a.G, N = a.N;
  const Layout L = layout_of(a.P, N, a.Nrows, R, D, G, a.Q, a.Kd, a.nw);
  const int nw = NW > 0 ? NW : a.nw;
  uint32_t* ar = SMEM ? dyn : a.scratch + L.spill;
  Ctx c;
  c.P = a.P;
  c.N = N;
  c.Nrows = a.Nrows;
  c.R = R;
  c.D = D;
  c.G = G;
  c.Q = a.Q;
  c.n_existing = a.n_existing;
  c.n_rows_real = a.n_rows_real;
  c.nw = nw;
  c.tile = L.tile;
  c.rec_words = L.rec_words;
  c.hreq = h_req(nw);
  c.hent = h_ent(nw, R);
  c.crow_words = L.crow_words;
  c.keymask = ar + L.keymask;
  c.rank_bits = ar + L.rank_bits;
  c.reg_bits = ar + L.reg_bits;
  c.dfeas = ar + L.dfeas;
  c.rank_ok = ar + L.rank_ok;
  c.rec_ring = ar + L.rec_ring;
  c.crow_ring = ar + L.crow_ring;
  c.kind = (int*)(ar + L.kind);
  c.skew = (int*)(ar + L.skew);
  c.min_dom = (int*)(ar + L.min_dom);
  c.counts_dom = (int*)(ar + L.counts_dom);
  c.t_basis = (int*)(ar + L.t_basis);
  c.t_rem = (float*)(ar + L.t_rem);
  c.t_ds = ar + L.t_ds;
  c.t_ch = (int*)(ar + L.t_ch);
  c.recs = a.scratch + L.recs;
  c.g_ds = a.scratch + L.domset;
  c.g_basis = a.slot_basis;
  c.g_rem = a.slot_rem;
  c.g_ch = a.counts_host;

  // -- constants, the carry into the tile, domain sets as bit sets, records --
  for (int e = tid; e < a.Kd * nw; e += NT) {
    const int k = e / nw, w = e - k * nw;
    uint32_t m = 0;
    for (int d = 32 * w; d < min(D, 32 * w + 32); ++d)
      if (a.dom_key_of[d] == k) m |= 1u << (d - 32 * w);
    c.keymask[e] = m;
  }
  for (int e = tid; e < a.Q * nw; e += NT) c.rank_bits[e] = plane_word(a.rank_domset, e / nw, D, e % nw);
  for (int e = tid; e < G * nw; e += NT) c.reg_bits[e] = plane_word(a.group_registered, e / nw, D, e % nw);
  for (int g = tid; g < G; g += NT) {
    c.kind[g] = a.group_kind[g];
    c.skew[g] = a.group_skew[g];
    c.min_dom[g] = a.group_min_domains[g];
  }
  for (int e = tid; e < G * D; e += NT) c.counts_dom[e] = a.counts_dom[e];
  const int tile = L.tile;
  for (int j = tid; j < tile; j += NT) c.t_basis[j] = a.slot_basis[j];
  for (int e = tid; e < tile * R; e += NT) c.t_rem[e] = a.slot_rem[e];
  for (int e = tid; e < G * tile; e += NT) {
    const int g = e / tile, j = e - g * tile;
    c.t_ch[e] = a.counts_host[(size_t)g * N + j];
  }
  for (int e = tid; e < nw * N; e += NT) {
    const int w = e / N, j = e - w * N;
    c.ds(j, w) = plane_word(a.slot_domset, j, D, w);
  }
  for (int i = tid; i < a.P; i += NT) {
    uint32_t* rec = a.scratch + L.recs + (size_t)i * L.rec_words;
    uint32_t* off = rec;
    int* ent = reinterpret_cast<int*>(rec + h_ent(nw, R));
    int n[N_LISTS];
    for (int l = 0; l < N_LISTS; ++l) n[l] = 0;
    int k_star = -1;
    for (int g = 0; g < G; ++g) {
      const int kind = a.group_kind[g];
      if (a.member[(size_t)i * G + g]) {
        if (kind == K_DOM_SPREAD || kind == K_DOM_ANTI) {
          ++n[L_DM];
          k_star = max(k_star, a.group_dom_key[g]);
        }
        n[L_SPREAD] += kind == K_DOM_SPREAD;
        n[L_ANTI] += kind == K_DOM_ANTI;
        n[L_HOST] += kind == K_HOST_SPREAD || kind == K_HOST_ANTI;
      }
      if (a.owner[(size_t)i * G + g]) {
        n[L_OWN_HS] += kind == K_HOST_SPREAD;
        n[L_OWN_HA] += kind == K_HOST_ANTI;
      }
    }
    int pos[N_LISTS];
    off[0] = 0;
    for (int l = 0; l < N_LISTS; ++l) {
      pos[l] = (int)off[l];
      off[l + 1] = off[l] + n[l];
    }
    off[N_LISTS + 1] = (n[L_DM] ? F_DM : 0) | (n[L_SPREAD] ? F_SPREAD : 0) | (n[L_ANTI] ? F_ANTI : 0) |
                       (n[L_HOST] ? F_HOST : 0) | (n[L_OWN_HS] + n[L_OWN_HA] ? F_OWN : 0);
    for (int g = 0; g < G; ++g) {
      const int kind = a.group_kind[g];
      if (a.member[(size_t)i * G + g]) {
        if (kind == K_DOM_SPREAD || kind == K_DOM_ANTI) ent[pos[L_DM]++] = g;
        if (kind == K_DOM_SPREAD) ent[pos[L_SPREAD]++] = g;
        if (kind == K_DOM_ANTI) ent[pos[L_ANTI]++] = g;
        if (kind == K_HOST_SPREAD || kind == K_HOST_ANTI) ent[pos[L_HOST]++] = g;
      }
      if (a.owner[(size_t)i * G + g]) {
        if (kind == K_HOST_SPREAD) ent[pos[L_OWN_HS]++] = g;
        if (kind == K_HOST_ANTI) ent[pos[L_OWN_HA]++] = g;
      }
    }
    uint32_t* sets = rec + H_SETS;
    for (int w = 0; w < nw; ++w) {
      sets[w] = plane_word(a.pod_dom_allowed, i, D, w);
      sets[nw + w] = plane_word(a.pod_restrict, i, a.Kd, w);
      uint32_t kmask = 0;
      for (int d = 32 * w; d < min(D, 32 * w + 32); ++d)
        if (a.dom_key_of[d] == k_star) kmask |= 1u << (d - 32 * w);
      sets[2 * nw + w] = kmask;
    }
    uint32_t* req = rec + h_req(nw);
    for (int r = 0; r < R; ++r) req[r] = __float_as_uint(a.pod_req[(size_t)i * R + r]);
    for (int r = R; r < RQ; ++r) req[r] = 0u;
  }
  if (tid == 0) {
    s_ready = 0;
    s_done = 0;
    s_stop = 0;
  }
  __threadfence_block();
  __syncthreads();

  // -- phase 1: warp 0 alone while open_count <= WARP_REACH ------------------
  // Warp 1 (the loader) copies pod k's record and compat row into ring slot
  // k & (NBUF - 1) once warp 0 is done with pod k - NBUF, and counts the
  // pods in (s_ready); warp 0 counts the pods it is done with (s_done) and
  // raises s_stop when it leaves the phase.
  if (warp == 0) {
    int open = a.open_count[0];
    int i = 0;
    for (; i < a.P && open <= WARP_REACH; ++i) {
      if (SMEM)
        while (ld_acquire(&s_ready) <= i) __nanosleep(32);
      const Pod p = pod_of<SMEM>(c, a, i, nw);
      const uint32_t dfe0 = dom_feasible<NW>(c, p, false);
      const int found = search_warp<NW, SH1>(c, p, dfe0, open);
      place<NW, SH1>(c, a, p, dfe0, i, found, open);
      if (SMEM && lane == 0) st_release(&s_done, i + 1);
    }
    if (lane == 0) {
      s_i0 = i;
      s_open = open;
      *(volatile int*)&s_stop = 1;
    }
  } else if (SMEM && warp == 1) {
    // every free ring slot's pod in flight at once, then published together
    for (int k = 0; k < a.P;) {
      const int done = __shfl_sync(FULL, ld_acquire(&s_done), 0);
      if (__shfl_sync(FULL, lane == 0 ? *(volatile int*)&s_stop : 0, 0)) break;
      const int end = min(a.P, done + NBUF);
      if (k == end) {
        __nanosleep(64);
        continue;
      }
#pragma unroll 1
      for (; k < end; ++k) prefetch(c, a, k);
      cp_async_wait<0>();
      __syncwarp();
      if (lane == 0) st_release(&s_ready, k);
    }
    cp_async_wait<0>();
  }
  __syncthreads();

  // -- phase 2: every warp searches, warp 0 decides ---------------------------
  int open = s_open;  // warp 0's copy is the one that counts
  const int loaded = SMEM ? s_ready : 0;  // pods [s_i0, loaded) are in the ring
  if (SMEM && warp == 0) {
    prefetch(c, a, s_i0, s_i0 < loaded);
    prefetch(c, a, s_i0 + 1, s_i0 + 1 < loaded);
  }
  for (int i = s_i0; i < a.P; ++i) {
    uint32_t dfe0 = 0;
    if (warp == 0) {
      begin_pod<SMEM>(c, a, i, loaded);
      dfe0 = dom_feasible<NW>(c, pod_of<SMEM>(c, a, i, nw), true);
      if (lane == 0) s_fm = NO_FIT;
    }
    __syncthreads();  // pod i's record and dom_feasible, the state, s_open
    const Pod p = pod_of<SMEM>(c, a, i, nw);
    search<NW, false>(c, p, warp == 0 ? dfe0 : c.dfeas[0], s_open, warp, NWARP, &s_fm);
    __syncthreads();  // every warp's fit is in s_fm
    if (warp == 0) {
      place<NW, false>(c, a, p, dfe0, i, *(volatile int*)&s_fm, open);
      if (lane == 0) s_open = open;
    }
  }

  // -- write the carry back ------------------------------------------------
  __syncthreads();
  for (int j = tid; j < tile; j += NT) a.slot_basis[j] = c.t_basis[j];
  for (int e = tid; e < tile * R; e += NT) a.slot_rem[e] = c.t_rem[e];
  for (int e = tid; e < G * tile; e += NT) {
    const int g = e / tile, j = e - g * tile;
    a.counts_host[(size_t)g * N + j] = c.t_ch[e];
  }
  for (int e = tid; e < N * D; e += NT) {
    const int j = e / D, d = e - j * D;
    a.slot_domset[e] = (c.ds(j, d >> 5) >> (d & 31)) & 1u;
  }
  for (int e = tid; e < G * D; e += NT) a.counts_dom[e] = c.counts_dom[e];
  if (tid == 0) a.open_count[0] = s_open;
}

static void fill_args(PerPodArgs& a, const long long* ptrs, const int* dims) {
  const void** p = reinterpret_cast<const void**>(&a);
  const int n_ptrs = 25;
  for (int k = 0; k < n_ptrs; ++k) p[k] = reinterpret_cast<const void*>(ptrs[k]);
  a.P = dims[0];
  a.N = dims[1];
  a.Nrows = dims[2];
  a.R = dims[3];
  a.D = dims[4];
  a.G = dims[5];
  a.Q = dims[6];
  a.Kd = dims[7];
  a.n_existing = dims[8];
  a.n_rows_real = dims[9];
  const int bits = max(max(a.D, a.Kd), a.Q);
  a.nw = max(1, (bits + 31) / 32);
}

static Layout layout_of_args(const PerPodArgs& a) {
  return layout_of(a.P, a.N, a.Nrows, a.R, a.D, a.G, a.Q, a.Kd, a.nw);
}

extern "C" int kt_perpod_pack(const long long* ptrs, const int* dims, void* stream) {
  PerPodArgs a;
  fill_args(a, ptrs, dims);
  const Layout L = layout_of_args(a);
  // one word per bit set with the arena and more than WARP_REACH slots in
  // shared memory (the common case) has its own build of the same code
  const void* kern = !L.arena_s                              ? (const void*)perpod_pack_kernel<0, false, false>
                     : a.nw == 1 && L.tile > WARP_REACH ? (const void*)perpod_pack_kernel<1, true, true>
                                                            : (const void*)perpod_pack_kernel<0, true, false>;
  const int smem = L.arena_s ? (int)(4 * L.arena_words) : 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  e = cudaLaunchKernel(kern, dim3(1), dim3(NT), args, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// int32 words of scratch the kernel needs (same dims as kt_perpod_pack)
extern "C" long long kt_perpod_pack_scratch(const int* dims) {
  PerPodArgs a;
  const long long none[25] = {0};
  fill_args(a, none, dims);
  return (long long)layout_of_args(a).words;
}
