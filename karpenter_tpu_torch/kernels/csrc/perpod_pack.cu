// K8 perpod_pack: the per-pod FFD scan, one persistent block.
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
// state pod i wrote, so each step is two block-wide barriers around a
// reduction over the open slots and the rows, plus a short serial update.
//
// Design: one block of NT threads walks the pods in order. Before the
// scan, every thread packs the state-independent facts of a stride of
// pods (allowed domains, constrained keys, the constrained key's domains as
// bit sets; their groups by role as ascending lists) into its record in
// the scratch. Every axis is sized from the problem: bit sets have nw 32-bit
// words, nw = ceil(max(D, Kd, Q) / 32); the kernel is built from the same
// code with nw fixed at 1 (the pod's sets then live in registers: `Set`)
// and with nw read, and with its arena in shared memory or in a global
// spill. Each pod's record is copied into shared memory two pods ahead, by
// warps 1.. while thread 0 decides the pod before. Per step:
//   - all threads: the first open slot that fits (slots past open_count
//     are closed: slots open in order, so only [0, open_count) is read;
//     each thread strides over it and stops at its first fit), and the
//     masked argmin of the K1 key over the rows (ties to the lowest row;
//     masked-out rows take the value BIG and still win ties below the
//     first fitting row, so a winner that does not fit means -1, exactly as
//     `masked_argmin`); warp shuffles, then one partial per warp;
//   - thread 0: the choice of slot, the domain commitment (cur_domset,
//     dom_cost, z_star, new_domset as bit sets), the update
//     of slot j and of counts_dom / counts_host (only the groups the pod
//     belongs to), then the next pod's dom_feasible (spread_ok_of over its
//     keyed groups only) and rank_ok, published through shared memory.
// The state lives in global memory (counts_host is [G, N], 16 x 5120
// int32 at the headline), except counts_dom, which sits with the constants
// in an arena of shared memory during the scan (in a global spill, behind
// the same pointers, where it does not fit). Domain sets are bit sets during
// the scan and are written back to the bool carry at the end. Bit-parity with the
// reference: rem_j is one IEEE f32 subtraction (built with -fmad=false),
// int32 sums wrap in unsigned arithmetic, ties go to the lowest index
// everywhere, and z_star is 0 (the NO_ZONE sentinel) when every domain
// costs INF.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define NWARP (NT / 32)
#define INF_I (1 << 30)
#define BIGF 3.4e38f
#define NO_FIT 0x7fffffff
#define SMEM_LIMIT 232448

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

// a pod's record: its bit sets, then its groups by role as ascending lists
enum { L_DM = 0, L_SPREAD, L_ANTI, L_HOST, L_OWN_HS, L_OWN_HA, N_LISTS };

// 4-byte words: the record of a pod; the arena (constants, counts_dom, the
// published pod and thread-0 scratch), in shared memory where it fits, else
// in the global scratch; the global scratch holds the slots' domain sets
// [nw][N], the records, then the arena if it spilled
struct Layout {
  int nw, rec_words;
  size_t keymask, rank_bits, reg_bits, kind, skew, min_dom, counts_dom, req, za, rs, kmask, dfeas, rank_ok, cur,
      spread_ok, okm, cur_rec, arena_words;
  size_t domset, recs, spill, words;
  bool arena_s;
};

__host__ __device__ inline Layout layout_of(int P, int N, int R, int D, int G, int Q, int Kd, int nw) {
  Layout L;
  L.nw = nw;
  L.rec_words = 3 * nw + N_LISTS + N_LISTS * G;
  size_t o = 0;
  L.keymask = o; o += (size_t)Kd * nw;
  L.rank_bits = o; o += (size_t)Q * nw;
  L.reg_bits = o; o += (size_t)G * nw;
  L.kind = o; o += G;
  L.skew = o; o += G;
  L.min_dom = o; o += G;
  L.counts_dom = o; o += (size_t)G * D;
  L.req = o; o += R;
  L.za = o; o += nw;
  L.rs = o; o += nw;
  L.kmask = o; o += nw;
  L.dfeas = o; o += nw;
  L.rank_ok = o; o += nw;
  L.cur = o; o += nw;
  L.spread_ok = o; o += nw;
  L.okm = o; o += nw;
  L.cur_rec = o; o += 3 * (size_t)L.rec_words;  // three pods' records: i, i + 1 and i + 2
  L.arena_words = o;
  L.arena_s = 4 * o + 1024 <= SMEM_LIMIT;  // room left for the static partials
  o = 0;
  L.domset = o; o += (size_t)nw * N;
  L.recs = o; o += (size_t)P * L.rec_words;
  L.spill = o; o += L.arena_s ? 0 : L.arena_words;
  L.words = o;
  return L;
}

struct Smem {
  int dm, open;
  // per-warp partials of the step's reductions
  int w_slot[NWARP];
  float w_v[NWARP];
  int w_i[NWARP];
  int w_f[NWARP];
};

// the arena's tables
struct Ctx {
  int nw;
  uint32_t *keymask, *rank_bits, *reg_bits, *za, *rs, *kmask, *dfeas, *rank_ok, *cur, *spread_ok, *okm, *domset;
  int *kind, *skew, *min_dom, *counts_dom;
  float* req;
  const uint32_t* recs;
  uint32_t* cur_rec;  // three buffers: pod i's record in buffer i % 3 (bit sets, list lengths, lists)
  int rec_words, G;
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
__device__ __forceinline__ uint32_t& ds_at(const Ctx& c, int N, int j, int w) { return c.domset[(size_t)w * N + j]; }

// perkey_dom_ok for one domain set (set(w): its word w): every constrained
// key keeps an allowed domain
template <class SetW, class ZA, class RS>
__device__ __forceinline__ bool perkey_ok(const Ctx& c, const SetW& set, const ZA& za, const RS& rs) {
  for (int w0 = 0; w0 < c.nw; ++w0)
    for (uint32_t k = rs[w0]; k; k &= k - 1) {
      const uint32_t* km = c.keymask + (size_t)(w0 * 32 + __ffs(k) - 1) * c.nw;
      bool hit = false;
      for (int w = 0; w < c.nw && !hit; ++w) hit = (set(w) & za[w] & km[w]) != 0;
      if (!hit) return false;
    }
  return true;
}

// (value, index, fits) lexicographic min: ties to the lowest index
__device__ __forceinline__ void argmin_merge(float& v, int& i, int& f, float v2, int i2, int f2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
    f = f2;
  }
}

__device__ __forceinline__ const uint32_t* rec_of(const Ctx& c, int i) { return c.recs + (size_t)i * c.rec_words; }
__device__ __forceinline__ int list_len(const Ctx& c, const uint32_t* rec, int l) { return (int)rec[3 * c.nw + l]; }
__device__ __forceinline__ const int* list_of(const Ctx& c, const uint32_t* rec, int l, int G) {
  return reinterpret_cast<const int*>(rec + 3 * c.nw + N_LISTS + (size_t)l * G);
}

// A set of NW words held in registers (NW > 0: every index is then a
// compile-time constant), or (NW == 0) a view of the arena's words.
template <int NW>
struct Set {
  uint32_t v[NW];
  __device__ __forceinline__ explicit Set(uint32_t*) {}
  __device__ __forceinline__ uint32_t& operator[](int w) { return v[w]; }
  __device__ __forceinline__ uint32_t operator[](int w) const { return v[w]; }
};
template <>
struct Set<0> {
  uint32_t* v;
  __device__ __forceinline__ explicit Set(uint32_t* p) : v(p) {}
  __device__ __forceinline__ uint32_t& operator[](int w) { return v[w]; }
  __device__ __forceinline__ uint32_t operator[](int w) const { return v[w]; }
};

// bit d of a set (a Set or a pointer to words): with one word every index
// is below 32
template <int NW, class M>
__device__ __forceinline__ bool tb(const M& m, int d) {
  return NW == 1 ? ((m[0] >> d) & 1u) != 0 : ((m[d >> 5] >> (d & 31)) & 1u) != 0;
}
template <int NW, class M>
__device__ __forceinline__ void tset(M& m, int d) {
  if (NW == 1) m[0] |= 1u << d;
  else m[d >> 5] |= 1u << (d & 31);
}

// a copy of the arena's set p: its words in registers (NW > 0), else a view
template <int NW>
__device__ __forceinline__ Set<NW> load_set(uint32_t* p) {
  Set<NW> out(p);
  if (NW > 0)
    for (int w = 0; w < NW; ++w) out[w] = p[w];
  return out;
}

// thread 0's working copy of a pod's bit sets: registers when the word count
// is fixed at compile time, else the arena's copies
template <int NW>
struct PodSets {
  Set<NW> za, rs, kmask, spread_ok, okm, dfeas, rank_ok, cur;
  __device__ __forceinline__ explicit PodSets(const Ctx& c)
      : za(c.za), rs(c.rs), kmask(c.kmask), spread_ok(c.spread_ok), okm(c.okm), dfeas(c.dfeas),
        rank_ok(c.rank_ok), cur(c.cur) {}
};

// pod i's record in shared memory: buffer i & 1
__device__ __forceinline__ uint32_t* cur_of(const Ctx& c, int i) { return c.cur_rec + (size_t)(i % 3) * c.rec_words; }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// threads [t0, NT): copy pod i's record into its buffer, asynchronously
// where the arena is in shared memory (the caller waits, then its next
// barrier publishes it)
template <bool SMEM>
__device__ __forceinline__ void fetch_record(const Ctx& c, int i, int t0) {
  const uint32_t* src = rec_of(c, i);
  uint32_t* dst = cur_of(c, i);
  for (int e = (int)threadIdx.x - t0; e < c.rec_words; e += NT - t0) {
    if (SMEM) cp_async4(dst + e, src + e);
    else dst[e] = src[e];
  }
}

// thread 0: publish pod i's per-step values (dom_feasible from the current
// counts_dom, rank_ok; its record is in its buffer) for the next parallel
// phase
template <int NW>
__device__ __forceinline__ void prepare_pod(const PerPodArgs& a, const Ctx& c, Smem& s, int i) {
  const int nw = NW > 0 ? NW : c.nw, D = a.D, G = a.G;
  const uint32_t* rec = cur_of(c, i);
  PodSets<NW> m(c);
  for (int w = 0; w < nw; ++w) {
    m.za[w] = rec[w];
    m.rs[w] = rec[nw + w];
    m.kmask[w] = rec[2 * nw + w];
    m.spread_ok[w] = full_word(D, w);
  }
  const int n_dm = list_len(c, rec, L_DM);
  const int* dm_groups = list_of(c, rec, L_DM, G);
  const int dm = n_dm != 0;
  for (int t = 0; t < n_dm; ++t) {
    const int g = dm_groups[t];
    const int* cd = c.counts_dom + (size_t)g * D;
    const uint32_t* reg = c.reg_bits + (size_t)g * nw;
    int zmin = INF_I, nzr = 0;
    for (int d = 0; d < D; ++d)
      if (tb<NW>(m.za, d) && tb<NW>(reg, d)) {
        zmin = min(zmin, cd[d]);
        ++nzr;
      }
    if (zmin >= INF_I) zmin = 0;
    if (c.min_dom[g] > 0 && nzr < c.min_dom[g]) zmin = 0;
    for (int w = 0; w < nw; ++w) m.okm[w] = 0;
    for (int d = 0; d < D; ++d) {
      bool o = c.kind[g] == K_DOM_ANTI ? cd[d] == 0 : (int)((unsigned)cd[d] + 1u - (unsigned)zmin) <= c.skew[g];
      if (o) tset<NW>(m.okm, d);
    }
    for (int w = 0; w < nw; ++w) m.spread_ok[w] &= m.okm[w] & reg[w];
  }
  for (int w = 0; w < nw; ++w) {
    m.dfeas[w] = dm ? (m.za[w] & m.spread_ok[w]) : m.za[w];
    m.rank_ok[w] = 0;
  }
  for (int q = 0; q < a.Q; ++q) {
    const uint32_t* rb = c.rank_bits + (size_t)q * nw;
    bool meets = !dm;
    for (int w = 0; w < nw && !meets; ++w) meets = (rb[w] & m.dfeas[w]) != 0;
    if (meets && perkey_ok(c, [&](int w) { return rb[w]; }, m.za, m.rs)) tset<NW>(m.rank_ok, q);
  }
  // publish: the arena's copies (the same storage when the word count is read)
  if (NW > 0)
    for (int w = 0; w < nw; ++w) {
      c.za[w] = m.za[w];
      c.rs[w] = m.rs[w];
      c.kmask[w] = m.kmask[w];
      c.dfeas[w] = m.dfeas[w];
      c.rank_ok[w] = m.rank_ok[w];
    }
  for (int r = 0; r < a.R; ++r) c.req[r] = a.pod_req[(size_t)i * a.R + r];
  s.dm = dm;
}

// NW > 0 fixes the words of every bit set at compile time; SMEM says the
// arena is in shared memory (so its loads are shared-memory loads)
template <int NW, bool SMEM>
__global__ void __launch_bounds__(NT, 1) perpod_pack_kernel(PerPodArgs a) {
  __shared__ Smem s;
  extern __shared__ __align__(16) uint32_t dyn[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.R, D = a.D, G = a.G, N = a.N, Nrows = a.Nrows;
  const Layout L = layout_of(a.P, N, R, D, G, a.Q, a.Kd, a.nw);
  const int nw = NW > 0 ? NW : a.nw;
  uint32_t* ar = SMEM ? dyn : a.scratch + L.spill;
  Ctx c;
  c.nw = nw;
  c.keymask = ar + L.keymask;
  c.rank_bits = ar + L.rank_bits;
  c.reg_bits = ar + L.reg_bits;
  c.kind = (int*)(ar + L.kind);
  c.skew = (int*)(ar + L.skew);
  c.min_dom = (int*)(ar + L.min_dom);
  c.counts_dom = (int*)(ar + L.counts_dom);
  c.req = (float*)(ar + L.req);
  c.za = ar + L.za;
  c.rs = ar + L.rs;
  c.kmask = ar + L.kmask;
  c.dfeas = ar + L.dfeas;
  c.rank_ok = ar + L.rank_ok;
  c.cur = ar + L.cur;
  c.spread_ok = ar + L.spread_ok;
  c.okm = ar + L.okm;
  c.domset = a.scratch + L.domset;
  c.recs = a.scratch + L.recs;
  c.cur_rec = ar + L.cur_rec;
  c.rec_words = L.rec_words;
  c.G = G;

  // -- constants, the carry's domain sets as bit sets, and the pods' facts -
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
  for (int e = tid; e < nw * N; e += NT) {
    const int w = e / N, j = e - w * N;
    c.domset[e] = plane_word(a.slot_domset, j, D, w);
  }
  for (int i = tid; i < a.P; i += NT) {
    uint32_t* rec = a.scratch + L.recs + (size_t)i * L.rec_words;
    int* n = reinterpret_cast<int*>(rec + 3 * nw);
    int* lists = n + N_LISTS;
    for (int l = 0; l < N_LISTS; ++l) n[l] = 0;
    int k_star = -1;
    for (int g = 0; g < G; ++g) {
      int kind = a.group_kind[g];
      if (a.member[(size_t)i * G + g]) {
        if (kind == K_DOM_SPREAD || kind == K_DOM_ANTI) {
          lists[L_DM * G + n[L_DM]++] = g;
          k_star = max(k_star, a.group_dom_key[g]);
        }
        if (kind == K_DOM_SPREAD) lists[L_SPREAD * G + n[L_SPREAD]++] = g;
        if (kind == K_DOM_ANTI) lists[L_ANTI * G + n[L_ANTI]++] = g;
        if (kind == K_HOST_SPREAD || kind == K_HOST_ANTI) lists[L_HOST * G + n[L_HOST]++] = g;
      }
      if (a.owner[(size_t)i * G + g]) {
        if (kind == K_HOST_SPREAD) lists[L_OWN_HS * G + n[L_OWN_HS]++] = g;
        if (kind == K_HOST_ANTI) lists[L_OWN_HA * G + n[L_OWN_HA]++] = g;
      }
    }
    for (int w = 0; w < nw; ++w) {
      rec[w] = plane_word(a.pod_dom_allowed, i, D, w);
      rec[nw + w] = plane_word(a.pod_restrict, i, a.Kd, w);
      uint32_t kmask = 0;
      for (int d = 32 * w; d < min(D, 32 * w + 32); ++d)
        if (a.dom_key_of[d] == k_star) kmask |= 1u << (d - 32 * w);
      rec[2 * nw + w] = kmask;
    }
  }
  __threadfence_block();
  __syncthreads();
  for (int i = 0; i < min(a.P, 2); ++i) fetch_record<SMEM>(c, i, 0);
  cp_async_wait_all();
  __syncthreads();
  int oc = a.open_count[0];  // thread 0's copy is the one that counts
  if (tid == 0) {
    s.open = oc;
    if (a.P > 0) prepare_pod<NW>(a, c, s, 0);
  }

  for (int i = 0; i < a.P; ++i) {
    __syncthreads();  // the state and pod i's values are published
    const uint8_t* compat_i = a.compat + (size_t)i * Nrows;
    const float* key_i = a.choose_key + (size_t)i * Nrows;
    const int open = s.open;
    const int dm = s.dm;
    const uint32_t* rec = cur_of(c, i);
    const int n_own_hs = list_len(c, rec, L_OWN_HS), n_own_ha = list_len(c, rec, L_OWN_HA);
    const int* own_hs = list_of(c, rec, L_OWN_HS, G);
    const int* own_ha = list_of(c, rec, L_OWN_HA, G);

    // first open slot that fits (each thread's first fit is its lowest)
    // the pod's sets, in registers where the word count is fixed
    const Set<NW> za = load_set<NW>(c.za), rs = load_set<NW>(c.rs), dfeas = load_set<NW>(c.dfeas);
    int best_j = NO_FIT;
    for (int j = tid; j < open; j += NT) {
      int b = a.slot_basis[j];
      bool f = b >= 0;
      for (int r = 0; r < R && f; ++r) f = c.req[r] <= a.slot_rem[(size_t)j * R + r];
      f = f && compat_i[min(max(b, 0), Nrows - 1)];
      if (f) {
        // the slot's domain set: one load where it is one word
        const uint32_t ds0 = NW == 1 ? ds_at(c, N, j, 0) : 0u;
        auto set = [&](int w) { return NW == 1 ? ds0 : ds_at(c, N, j, w); };
        f = perkey_ok(c, set, za, rs);
        if (f && dm) {
          bool meets = false;
          for (int w = 0; w < nw && !meets; ++w) meets = (set(w) & dfeas[w]) != 0;
          f = meets;
        }
      }
      for (int t = 0; t < n_own_hs && f; ++t) {
        int g = own_hs[t];
        f = wrap_add(a.counts_host[(size_t)g * N + j], 1) <= c.skew[g];
      }
      for (int t = 0; t < n_own_ha && f; ++t) f = a.counts_host[(size_t)own_ha[t] * N + j] == 0;
      if (f) {
        best_j = j;
        break;
      }
    }
    // masked argmin of the row key over the rows
    float bv = BIGF;
    int bi = NO_FIT, bf = 0;
    const bool can_open = open < N;
    for (int r = tid; r < Nrows; r += NT) {
      bool f = can_open && r >= a.n_existing && r < a.n_rows_real && compat_i[r];
      for (int k = 0; k < R && f; ++k) f = c.req[k] <= a.row_alloc[(size_t)r * R + k];
      f = f && tb<NW>(c.rank_ok, min(max(a.row_pool_rank[r], 0), a.Q - 1));
      argmin_merge(bv, bi, bf, f ? key_i[r] : BIGF, r, f ? 1 : 0);
    }
    best_j = (int)__reduce_min_sync(0xffffffffu, (unsigned)best_j);
    for (int off = 16; off; off >>= 1) {
      float v2 = __shfl_down_sync(0xffffffffu, bv, off);
      int i2 = __shfl_down_sync(0xffffffffu, bi, off);
      int f2 = __shfl_down_sync(0xffffffffu, bf, off);
      argmin_merge(bv, bi, bf, v2, i2, f2);
    }
    if (lane == 0) {
      s.w_slot[warp] = best_j;
      s.w_v[warp] = bv;
      s.w_i[warp] = bi;
      s.w_f[warp] = bf;
    }
    __syncthreads();  // the partials are in; thread 0 decides and updates
    if (warp > 0) {
      // idle while thread 0 decides: pod i + 2's record into the buffer pod
      // i - 1 left (the next barrier publishes it)
      if (i + 2 < a.P) fetch_record<SMEM>(c, i + 2, 32);
      cp_async_wait_all();
    }
    if (tid == 0) {
      int j_slot = NO_FIT;
      float v = BIGF;
      int o = NO_FIT, of = 0;
      for (int w = 0; w < NWARP; ++w) {
        j_slot = min(j_slot, s.w_slot[w]);
        argmin_merge(v, o, of, s.w_v[w], s.w_i[w], s.w_f[w]);
      }
      const bool use_slot = j_slot != NO_FIT;
      const int o_new = of ? o : -1;
      const int j = use_slot ? j_slot : (o_new >= 0 ? oc : -1);
      a.assignment[i] = j;
      if (j >= 0) {
        const int safe_o = min(max(o_new, 0), Nrows - 1);
        const int rank_o = a.row_pool_rank[safe_o];
        const uint32_t* rbo = c.rank_bits + (size_t)min(max(rank_o, 0), a.Q - 1) * nw;
        PodSets<NW> ms(c);
        Set<NW>& cur = ms.cur;
        Set<NW>& kmask = ms.kmask;
        for (int w = 0; w < nw; ++w) {
          kmask[w] = c.kmask[w];
          const uint32_t m = dm ? kmask[w] : 0u;
          cur[w] = (use_slot ? ds_at(c, N, j, w) : rbo[w]) & ((dfeas[w] & m) | (za[w] & ~m));
        }
        // dom_cost: the keyed groups' counts summed per domain; argmin, ties low
        const int n_dm = list_len(c, rec, L_DM);
        const int* dm_groups = list_of(c, rec, L_DM, G);
        int z_star = 0, best = 0;
        for (int d = 0; d < D; ++d) {
          int cost = INF_I;
          if (tb<NW>(cur, d) && tb<NW>(kmask, d)) {
            unsigned sum = 0;
            for (int t = 0; t < n_dm; ++t) sum += (unsigned)c.counts_dom[(size_t)dm_groups[t] * D + d];
            cost = (int)sum;
          }
          if (d == 0 || cost < best) {
            best = cost;
            z_star = d;
          }
        }
        const int n_spread = list_len(c, rec, L_SPREAD);
        const bool narrow = dm && n_spread;
        // new set: the committed domain of the key, the rest of cur; the
        // anti-affinity groups below count its keyed domains (`blocked`)
        Set<NW>& blocked = ms.okm;
        for (int w = 0; w < nw; ++w) {
          const uint32_t zb = (z_star >> 5) == w ? 1u << (z_star & 31) : 0u;
          const uint32_t ns = narrow ? ((kmask[w] & zb) | (cur[w] & ~kmask[w])) & cur[w] : cur[w];
          ds_at(c, N, j, w) = ns;
          blocked[w] = ns & kmask[w];
        }

        if (!use_slot) a.slot_basis[j] = o_new;
        for (int r = 0; r < R; ++r) {
          float base = use_slot ? a.slot_rem[(size_t)j * R + r] : a.row_alloc[(size_t)safe_o * R + r];
          a.slot_rem[(size_t)j * R + r] = __fsub_rn(base, c.req[r]);
        }
        if (!use_slot) {
          a.slot_rank[j] = rank_o;
          ++oc;
        }
        if (dm) {
          const int* spread = list_of(c, rec, L_SPREAD, G);
          for (int t = 0; t < n_spread; ++t) {
            int* cd = &c.counts_dom[(size_t)spread[t] * D + z_star];
            *cd = wrap_add(*cd, 1);
          }
        }
        const int n_anti = list_len(c, rec, L_ANTI);
        const int* anti = list_of(c, rec, L_ANTI, G);
        for (int t = 0; t < n_anti; ++t)
          for (int w = 0; w < nw; ++w)
            for (uint32_t b = blocked[w]; b; b &= b - 1) {
              int* cd = &c.counts_dom[(size_t)anti[t] * D + 32 * w + __ffs(b) - 1];
              *cd = wrap_add(*cd, 1);
            }
        const int n_host = list_len(c, rec, L_HOST);
        const int* host = list_of(c, rec, L_HOST, G);
        for (int t = 0; t < n_host; ++t) {
          int* ch = &a.counts_host[(size_t)host[t] * N + j];
          *ch = wrap_add(*ch, 1);
        }
      }
      s.open = oc;
      if (i + 1 < a.P) prepare_pod<NW>(a, c, s, i + 1);
    }
  }

  // -- write the carry back ------------------------------------------------
  __syncthreads();
  for (int j = tid; j < N; j += NT)
    for (int d = 0; d < D; ++d) a.slot_domset[(size_t)j * D + d] = (ds_at(c, N, j, d >> 5) >> (d & 31)) & 1u;
  for (int e = tid; e < G * D; e += NT) a.counts_dom[e] = c.counts_dom[e];
  if (tid == 0) a.open_count[0] = s.open;
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

extern "C" int kt_perpod_pack(const long long* ptrs, const int* dims, void* stream) {
  PerPodArgs a;
  fill_args(a, ptrs, dims);
  const Layout L = layout_of(a.P, a.N, a.R, a.D, a.G, a.Q, a.Kd, a.nw);
  // one word per bit set with the arena in shared memory (the common case)
  // has its own build of the same code
  const void* kern = !L.arena_s ? (const void*)perpod_pack_kernel<0, false>
                     : a.nw == 1 ? (const void*)perpod_pack_kernel<1, true>
                                 : (const void*)perpod_pack_kernel<0, true>;
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
  return (long long)layout_of(a.P, a.N, a.R, a.D, a.G, a.Q, a.Kd, a.nw).words;
}
