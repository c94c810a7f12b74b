// K2 pack_scan: the signature-grouped FFD pack scan, one persistent block
// (with helper blocks that build the item data first).
//
// Replaces: karpenter_tpu/models/scheduler_model_grouped.py `_pack_body`
// (:450-994) as run by `_pack_compressed_impl` (:1028) and
// `_pack_delta_compressed_impl` (:1046): the lax.scan over W signature items
// with its five lax.switch branches (simple / zone / anti / dom-affinity /
// host-affinity), `place` (:657), `_int_cap`/`_int_cap_nd` (:295/:303),
// `_waterfill` (:311) and `_waterfill_multi` (:346).
//
// What bounds it on an H100: not bytes (the carry plus the [W, N] take
// matrix is ~11 MB at the headline shape, ~3 us at 3.35 TB/s) and not
// arithmetic, but the sequential chain: item i+1 reads the carry item i
// wrote, so every step's latency adds up. Measured on the earlier design
// (one 1024-thread block over all N slots, item prologue in thread 0):
// ~45% serial thread-0 loads, ~34% global-load chains in the slot and row
// loops, ~17% barriers and block reductions.
//
// Design, all aimed at the latency of one item:
// - Only slots in [0, open_count) can take a pod (a slot past it has basis
//   -1, no domain or port bits and no host counts; `place` opens slots at
//   the running open_count), so every slot loop stops there; the slots past
//   it pass through untouched.
// - The state of the first TILE slots (basis, rank, remaining capacity,
//   domain and port sets as 32-bit masks, the call's take) lives in shared
//   memory for the whole scan, loaded once and written back once; slots past
//   the tile keep theirs in global memory (the carry buffers and a scratch
//   of masks), behind the same accessors. Rows likewise: the first
//   ROW_TILE rows' data in shared memory, the rest read from global memory. Slot j is always handled by thread
//   j % NT, so a slot's state needs no barrier between phases.
// - 256 threads, so the register cap lifts; thread-0 scratch lives in
//   shared memory and nothing lands on the stack.
// - What an item needs that does not depend on the carry is built for all
//   items before the scan by the other blocks of the launch (cooperative,
//   so all co-resident), one warp per item: its masks, its ordered group
//   lists (one lane per group; ballots keep ascending group order), its open
//   caps (one lane per rank and domain), per row the fits and capacity of a
//   fresh slot, and the compat and host-blocked bitmaps. Block 0 loads the
//   slot tile meanwhile, waits once on their count, and during the scan
//   copies item i+1's data into shared memory (cp.async) while item i runs.
// - A `place()` call has one block exchange: warp-level scans of the slot
//   capacities, the row argmin and the largest capacity are combined through
//   shared memory after one barrier (`gprefix`). The take total (`gsum`) is
//   min(count, total capacity) whenever no prefix can wrap in int32
//   (largest capacity x open slots < 2^31 and a count >= 0), else a second
//   exchange; the decision on the best row runs in every thread on the same
//   values; the total of the fresh slots' takes is closed form; the OR of
//   touched domains (`gany_slots`) is exchanged only where the anti branch
//   needs it. These three keep the slot-axis exchanges of the meshed
//   reference (`gprefix`, `gsum`, `gany_slots`, :486-512) as steps of their
//   own. Exchange buffers alternate between calls, so a fast warp never
//   overwrites what a slow one still reads.
// Bit-parity with the reference: IEEE division and no FMA contraction
// (built with -fmad=false, explicit __f*_rn), int32 wraparound done in
// unsigned arithmetic, floor division for the reference's `//`, ties to the
// lowest index everywhere.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define NWARP (NT / 32)
#define TILE 1024
#define ROW_TILE 1024
#define MAX_R 16
#define MAX_G 256
#define MAX_Q 32
#define MAX_D 32
#define MAX_KD 32
#define INF_I (1 << 30)
#define BIGF 3.4e38f
#define FULL 0xffffffffu
#define SMEM_LIMIT 232448
#define MAX_ITEM_BLOCKS 64

enum { K_DOM_SPREAD = 0, K_HOST_SPREAD = 1, K_HOST_ANTI = 2, K_DOM_ANTI = 3, K_DOM_AFF = 4, K_HOST_AFF = 5 };
// eligibility of a slot for one place() call
enum { EL_ALL = 0, EL_ZONE = 1, EL_ANTI = 2, EL_REC = 3 };
// which template ranks may open fresh slots in one place() call
enum { RK_ALL = 0, RK_BITS = 1, RK_NONE = 2 };

struct PackArgs {
  const float* row_alloc;          // [Nrows, R]
  const int* row_pool_rank;        // [Nrows]
  const uint8_t* rank_domset;      // [Q, D]
  const float* rank_dom_cap;       // [Q, D, R]
  const int* dom_key_of;           // [D]
  const int* group_kind;           // [G]
  const int* group_skew;           // [G]
  const int* group_dom_key;        // [G]
  const int* group_min_domains;    // [G]
  const uint8_t* group_registered; // [G, D]
  const uint8_t* row_port_any;     // [Nrows, P1]
  const uint8_t* row_port_wild;    // [Nrows, P1]
  const uint8_t* row_port_spec;    // [Nrows, P2]
  const float* item_req;           // [W, R]
  const uint8_t* item_dom_allowed; // [W, D]
  const uint8_t* item_restrict;    // [W, Kd]
  const uint8_t* item_member;      // [W, G]
  const uint8_t* item_owner;       // [W, G]
  const int* item_count;           // [W]
  const uint8_t* item_port_any;    // [W, P1]
  const uint8_t* item_port_wild;   // [W, P1]
  const uint8_t* item_port_spec;   // [W, P2]
  const uint8_t* item_host_blocked;// [W, HB]
  const uint8_t* compat;           // [W, Nrows]
  const float* choose_key;         // [W, Nrows]
  int* slot_basis;                 // [N]      carry, in/out
  float* slot_rem;                 // [N, R]
  uint8_t* slot_zoneset;           // [N, D]
  int* slot_rank;                  // [N]
  int* counts_zone;                // [G, D]
  int* counts_host;                // [G, N]
  int* open_count;                 // [1]
  uint8_t* slot_pany;              // [N, P1]
  uint8_t* slot_pwild;             // [N, P1]
  uint8_t* slot_pspec;             // [N, P2]
  int* takes;                      // [W, N] zero-filled by the caller
  int* leftovers;                  // [W]
  int* scratch;                    // [5 N]: masks and takes of slots past the tile
  int W, N, Nrows, R, D, G, Q, Kd, P1, P2, HB, n_existing, n_rows_real;
};

// what one item needs during its scan (built by warp 0, two buffers)
struct __align__(16) ItemSm {
  float req[MAX_R];
  uint32_t za, kmask, restrict_all, restrict_other, pany, pwild, pspec;
  uint32_t rank_ok_all, rank_ok_other;  // bit q: the rank's domains pass the per-key restriction
  uint32_t rank_fits[MAX_Q];            // bit d: a fresh slot of rank q in domain d holds one pod
  uint32_t openable;                    // OR of rank_bits & rank_fits over fitting rows (rows pass)
  int c, port_cap, host_cap_new, branch;
  int n_zmm, n_hown, n_hmem, n_haff;
  uint8_t zmm[MAX_G];   // keyed-domain member groups
  uint8_t hown[MAX_G];  // hostname gate groups the item owns
  uint8_t hmem[MAX_G];  // hostname-counted groups the item is in
  uint8_t haff[MAX_G];  // hostname-affinity groups the item owns
};

struct Smem {
  // constants of the problem
  uint32_t keymask[MAX_KD];   // domains of each dom key
  uint32_t rank_bits[MAX_Q];  // rank_domset as masks
  uint32_t reg_bits[MAX_G];   // group_registered as masks
  int gkind[MAX_G], gskew[MAX_G];
  ItemSm it[2];
  // block exchanges, two buffers each
  float xa_v[2][NWARP];
  int xa_i[2][NWARP];
  unsigned xmax[2][NWARP], xred[2][NWARP];
  // thread 0 -> all threads
  int pub_i[2];
  uint32_t pub_u[2][2];
  // thread-0 scratch of the zone, anti and affinity branches
  int inc[MAX_D], placed_z[MAX_D], vsum[MAX_D], capd[MAX_D], wcap[MAX_D], lvl[MAX_D], react[MAX_D];
  float wv[MAX_D];
  int wf_a[MAX_G], wf_b[MAX_G], wf_c[MAX_G];
  uint32_t wf_ok[MAX_G];
};

// dynamic shared memory (4-byte words): the slot tile, the row tile's ranks
// and port masks, the rank caps, the double-buffered item data and the
// prefix exchange. The row tile holds the first ROW_TILE rows (rows past it
// are read from global memory); the slot tile up to TILE slots, fewer where
// the rest leaves less room.
struct Layout {
  int tile, rt, nch, nrw, nb;
  size_t basis, rank, zs, pa, pw, ps, tk, tki, tkv, rem, rowrank, rpa, rpw, rps, rdcap, dcls;
  size_t opencap, rowinfo, rowkey, cbits, hbw, xtot, bytes;
};

__host__ __device__ inline Layout layout_of(int N, int Nrows, int R, int Q, int D, int n_existing) {
  Layout L;
  L.nch = (N + NT - 1) / NT;
  L.nrw = (Nrows + 31) / 32;
  L.nb = ((n_existing < N ? n_existing : N) + 31) / 32;
  L.rt = Nrows < ROW_TILE ? Nrows : ROW_TILE;
  const long long fixed = (long long)L.rt * 8 + (long long)Q * D * (R + 3) + 2LL * (L.nrw + L.nb) +
                          2LL * L.nch * NWARP;
  const long long room = ((long long)SMEM_LIMIT - (long long)sizeof(Smem)) / 4 - fixed;
  long long tile = room > 0 ? room / (9 + R) : 0;
  tile = tile < N ? tile : N;
  L.tile = (int)(tile < TILE ? tile : TILE);
  size_t o = 0;
  L.basis = o; o += L.tile;
  L.rank = o; o += L.tile;
  L.zs = o; o += L.tile;
  L.pa = o; o += L.tile;
  L.pw = o; o += L.tile;
  L.ps = o; o += L.tile;
  L.tk = o; o += L.tile;
  L.tki = o; o += L.tile;
  L.tkv = o; o += L.tile;
  L.rem = o; o += (size_t)R * L.tile;
  L.rowrank = o; o += L.rt;
  L.rpa = o; o += L.rt;
  L.rpw = o; o += L.rt;
  L.rps = o; o += L.rt;
  L.rdcap = o; o += (size_t)Q * D * R;
  L.dcls = o; o += (size_t)Q * D;
  L.opencap = o; o += 2 * (size_t)Q * D;
  L.rowinfo = o; o += 2 * (size_t)L.rt;
  L.rowkey = o; o += 2 * (size_t)L.rt;
  L.cbits = o; o += 2 * (size_t)L.nrw;
  L.hbw = o; o += 2 * (size_t)L.nb;
  L.xtot = o; o += 2 * (size_t)L.nch * NWARP;
  L.bytes = o * 4;
  return L;
}

// global scratch (4-byte words, zero-filled by the caller): the count of
// finished item blocks, masks and takes of the slots past the tile, then per
// item its record, open caps, rows (fits | cap), compat bits over the rows
// and host-blocked bits over the existing slots
#define REC_WORDS ((int)(sizeof(ItemSm) / 4))
struct Scratch {
  size_t done, far, recs, opencap, rowinfo, cbits, hbw, words;
};

__host__ __device__ inline Scratch scratch_of(int W, int N, int Nrows, int Q, int D, int n_existing) {
  const Layout L = layout_of(N, Nrows, 1, Q, D, n_existing);
  Scratch S;
  size_t o = 0;
  S.done = o; o += 4;
  S.far = o; o += 5 * (size_t)N;
  o = (o + 3) & ~(size_t)3;  // 16-byte records
  S.recs = o; o += (size_t)W * REC_WORDS;
  S.opencap = o; o += (size_t)W * Q * D;
  S.rowinfo = o; o += (size_t)W * Nrows;
  S.cbits = o; o += (size_t)W * L.nrw;
  S.hbw = o; o += (size_t)W * L.nb;
  S.words = o;
  return S;
}

// the block's view of the slot state (shared for j < tile, global past it),
// of the rows and of the item data
struct Ctx {
  int tile, rt, nch, nrw, nb;
  int *sb, *sr, *stk, *stki, *stkv;
  uint32_t *szs, *spa, *spw, *sps;
  float* srem;
  uint32_t *gzs, *gpa, *gpw, *gps;
  int* gtk;
  int* rowrank;  // row_pool_rank of the row tile
  uint32_t *rpa, *rpw, *rps;  // port masks of the row tile
  float* rdcap;
  uint32_t* dcls;  // [Q, D]: the domains whose rank caps equal d's, bit for bit
  int *opencap, *rowinfo;  // rowinfo: row_cap | fits << 31
  float* rowkey;
  uint32_t *cbits, *hbw;
  unsigned* xtot;
  ItemSm* g_recs;
  int *g_opencap, *g_rowinfo;
  uint32_t *g_cbits, *g_hbw;
};

// the current item's data in shared memory (its rows past the row tile in
// global memory)
struct ItemView {
  const ItemSm& I;
  const int* opencap;
  const int* rowinfo;
  const float* rowkey;
  const uint32_t* cbits;
  const uint32_t* hbw;
  const int* g_rowinfo;
  const float* g_rowkey;
};

struct Place {
  int cnt, el, rk;
  uint32_t elbits, restrict_mask, narrow, rkbits;
  bool want_blocked;
};

struct Placed {
  int left;
  uint32_t blocked;
};

__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int wmul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }
__device__ __forceinline__ uint32_t full_mask(int n) { return n >= 32 ? 0xffffffffu : ((1u << n) - 1u); }

__device__ __forceinline__ int row_rank(const Ctx& k, const PackArgs& a, int r) {
  return r < k.rt ? k.rowrank[r] : a.row_pool_rank[r];
}
__device__ __forceinline__ int rowq_of(const Ctx& k, const PackArgs& a, int r) { return clampi(row_rank(k, a, r), 0, a.Q - 1); }
__device__ __forceinline__ int row_info(const Ctx& k, const ItemView& V, int r) { return r < k.rt ? V.rowinfo[r] : V.g_rowinfo[r]; }
__device__ __forceinline__ float row_key(const Ctx& k, const ItemView& V, int r) { return r < k.rt ? V.rowkey[r] : V.g_rowkey[r]; }

// a row's host-port planes as masks
__device__ __forceinline__ void row_port_masks(const PackArgs& a, int r, uint32_t& pa, uint32_t& pw, uint32_t& ps) {
  pa = pw = ps = 0;
  for (int p = 0; p < a.P1; ++p) {
    pa |= (uint32_t)(a.row_port_any[(size_t)r * a.P1 + p] != 0) << p;
    pw |= (uint32_t)(a.row_port_wild[(size_t)r * a.P1 + p] != 0) << p;
  }
  for (int p = 0; p < a.P2; ++p) ps |= (uint32_t)(a.row_port_spec[(size_t)r * a.P2 + p] != 0) << p;
}
__device__ __forceinline__ void row_ports(const Ctx& k, const PackArgs& a, int r, uint32_t& pa, uint32_t& pw,
                                          uint32_t& ps) {
  if (r < k.rt) {
    pa = k.rpa[r];
    pw = k.rpw[r];
    ps = k.rps[r];
  } else {
    row_port_masks(a, r, pa, pw, ps);
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(gmem));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ int& basis_at(const Ctx& k, const PackArgs& a, int j) { return j < k.tile ? k.sb[j] : a.slot_basis[j]; }
__device__ __forceinline__ int& rank_at(const Ctx& k, const PackArgs& a, int j) { return j < k.tile ? k.sr[j] : a.slot_rank[j]; }
__device__ __forceinline__ int& tk_at(const Ctx& k, int j) { return j < k.tile ? k.stk[j] : k.gtk[j]; }
__device__ __forceinline__ uint32_t& zs_at(const Ctx& k, int j) { return j < k.tile ? k.szs[j] : k.gzs[j]; }
__device__ __forceinline__ uint32_t& pa_at(const Ctx& k, int j) { return j < k.tile ? k.spa[j] : k.gpa[j]; }
__device__ __forceinline__ uint32_t& pw_at(const Ctx& k, int j) { return j < k.tile ? k.spw[j] : k.gpw[j]; }
__device__ __forceinline__ uint32_t& ps_at(const Ctx& k, int j) { return j < k.tile ? k.sps[j] : k.gps[j]; }
__device__ __forceinline__ float& rem_at(const Ctx& k, const PackArgs& a, int j, int r) {
  return j < k.tile ? k.srem[(size_t)r * k.tile + j] : a.slot_rem[(size_t)j * a.R + r];
}

// takes[i, j] += take. A tile slot keeps the item's running take in shared
// memory, so the global take matrix is only written.
__device__ __forceinline__ void add_take(const Ctx& k, const PackArgs& a, int i, int j, int take) {
  int* tp = a.takes + (size_t)i * a.N + j;
  if (j < k.tile) {
    const int v = k.stki[j] == i ? wadd(k.stkv[j], take) : take;
    k.stki[j] = i;
    k.stkv[j] = v;
    *tp = v;
  } else {
    *tp = wadd(*tp, take);
  }
}

// one resource's term of `_int_cap`: floor(v / req), or BIG where not requested
__device__ __forceinline__ float cap_term(float v, float q) { return q > 0.f ? floorf(__fdiv_rn(v, fmaxf(q, 1e-9f))) : BIGF; }
__device__ __forceinline__ int cap_int(float cap) { return (int)fminf(fmaxf(cap, 0.f), 1073741824.f); }

// min over requested resources of floor(v / req), clipped to [0, 2^30]
__device__ __forceinline__ int int_cap(const float* v, const float* req, int R) {
  float cap = BIGF;
#pragma unroll 4
  for (int r = 0; r < R; ++r) cap = fminf(cap, cap_term(v[r], req[r]));
  return cap_int(cap);
}

__device__ __forceinline__ int int_cap_slot(const Ctx& k, const PackArgs& a, int j, const float* req) {
  float cap = BIGF;
#pragma unroll 4
  for (int r = 0; r < a.R; ++r) cap = fminf(cap, cap_term(rem_at(k, a, j, r), req[r]));
  return cap_int(cap);
}

__device__ __forceinline__ bool perkey_ok(const Smem& s, uint32_t za, uint32_t zs, uint32_t restrict_mask) {
  uint32_t inter = zs & za;
  while (restrict_mask) {
    int kk = __ffs(restrict_mask) - 1;
    restrict_mask &= restrict_mask - 1;
    if ((inter & s.keymask[kk]) == 0) return false;
  }
  return true;
}

__device__ __forceinline__ bool slot_compat(const Ctx& k, const PackArgs& a, const ItemView& V, int j) {
  const int b = basis_at(k, a, j);
  if (b < 0) return false;
  const int cb = clampi(b, 0, a.Nrows - 1);
  if (!((V.cbits[cb >> 5] >> (cb & 31)) & 1u)) return false;
  return !(j < a.n_existing && ((V.hbw[j >> 5] >> (j & 31)) & 1u));
}

__device__ __forceinline__ bool port_ok(const Ctx& k, const ItemSm& I, int j) {
  return ((pa_at(k, j) & I.pwild) | (pw_at(k, j) & I.pany) | (ps_at(k, j) & I.pspec)) == 0;
}

__device__ __forceinline__ bool rec_ok(const PackArgs& a, const ItemSm& I, int j) {
  for (int t = 0; t < I.n_haff; ++t)
    if (a.counts_host[(size_t)I.haff[t] * a.N + j] <= 0) return false;
  return true;
}

// per-slot capacity of one place() call (0 where ineligible)
__device__ __forceinline__ int slot_cap(const Ctx& k, const PackArgs& a, const Smem& s, const ItemView& V,
                                        const Place& P, int j) {
  const ItemSm& I = V.I;
  if (!slot_compat(k, a, V, j)) return 0;
  uint32_t zs = zs_at(k, j);
  if (!perkey_ok(s, I.za, zs, P.restrict_mask)) return 0;
  if ((P.el == EL_ZONE || P.el == EL_ANTI) && (zs & P.elbits) == 0) return 0;
  if (P.el == EL_REC && !rec_ok(a, I, j)) return 0;
  if (!port_ok(k, I, j)) return 0;
  const int R = a.R;
  // every term is clipped at 0 in the end, so a zero (or negative) term
  // decides without the others
  const int cap_res = int_cap_slot(k, a, j, I.req);
  if (cap_res <= 0 || I.port_cap <= 0) return 0;
  int mhc = INF_I;
  for (int t = 0; t < I.n_hown; ++t) {
    int g = I.hown[t];
    int ch = a.counts_host[(size_t)g * a.N + j];
    int v = s.gkind[g] == K_HOST_SPREAD ? wsub(s.gskew[g], ch) : (ch == 0 ? 1 : 0);
    mhc = min(mhc, v);
  }
  if (mhc <= 0) return 0;
  int rank = rank_at(k, a, j);
  int cap_dom;
  if (rank < 0) {
    cap_dom = INF_I;
  } else {
    const float* alloc = a.row_alloc + (size_t)clampi(basis_at(k, a, j), 0, a.Nrows - 1) * R;
    const float* rdc = k.rdcap + (size_t)clampi(rank, 0, a.Q - 1) * a.D * R;
    // the max over the target domains of the capacity left under each
    // domain's cap: domains of this rank with equal caps give equal terms,
    // so one of each class is evaluated
    const uint32_t* cls = k.dcls + (size_t)clampi(rank, 0, a.Q - 1) * a.D;
    cap_dom = 0;
    uint32_t target = zs & P.narrow;
    while (target) {
      int d = __ffs(target) - 1;
      target &= ~cls[d];
      float cap = BIGF;
#pragma unroll 4
      for (int r = 0; r < R; ++r) {
        float total = __fsub_rn(alloc[r], rem_at(k, a, j, r));
        cap = fminf(cap, cap_term(__fsub_rn(rdc[d * R + r], total), I.req[r]));
      }
      cap_dom = max(cap_dom, cap_int(cap));
    }
  }
  int capj = min(min(min(cap_res, cap_dom), mhc), I.port_cap);
  return clampi(capj, 0, INF_I);
}

__device__ __forceinline__ unsigned warp_incl_scan(unsigned x, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    unsigned t = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += t;
  }
  return x;
}

__device__ __forceinline__ bool rank_ok(const Smem& s, const ItemSm& I, const Place& P, int q) {
  return P.rk == RK_ALL ? ((I.rank_ok_all >> q) & 1u) != 0
         : P.rk == RK_NONE ? false
                           : ((s.rank_bits[q] & P.rkbits) != 0 && ((I.rank_ok_other >> q) & 1u) != 0);
}

// the slot-axis OR (gany_slots): one exchange
__device__ __forceinline__ uint32_t gany_slots(Smem& s, uint32_t v, int& xc) {
  v = __reduce_or_sync(FULL, v);
  const int b = xc & 1;
  if ((threadIdx.x & 31) == 0) s.xred[b][threadIdx.x >> 5] = v;
  __syncthreads();
  ++xc;
  uint32_t out = 0;
  for (int w = 0; w < NWARP; ++w) out |= s.xred[b][w];
  return out;
}

// Place P.cnt identical pods: prefix-sum first-fit over the eligible open
// slots, then fresh slots of the best row for the leftover. `oc` is the
// running open count and `xc` the exchange count (both the same in every
// thread). Returns the leftover and, where asked, the OR of the touched
// slots' narrowed domain sets.
__device__ __forceinline__ Placed place(const Ctx& k, const PackArgs& a, Smem& s, const ItemView& V, const Place& P,
                                        int i, int& oc, int& xc) {
  const ItemSm& I = V.I;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int R = a.R, Nr = a.Nrows;
  const int oc0 = oc, nch = (oc0 + NT - 1) / NT;

  // -- gprefix, first half: capacities and warp scans of the open slots; the
  //    row argmin and the largest capacity ride on the same exchange
  const int b1 = xc & 1;
  unsigned* tot = k.xtot + (size_t)b1 * k.nch * NWARP;
  unsigned mx = 0, cap0 = 0, excl0 = 0;  // chunk 0's capacity and warp prefix stay in registers
  for (int c = 0; c < nch; ++c) {
    const int j = c * NT + tid;
    const int cap = j < oc0 ? slot_cap(k, a, s, V, P, j) : 0;
    if (j < oc0) tk_at(k, j) = cap;
    const unsigned incl = warp_incl_scan((unsigned)cap, lane);
    if (lane == 31) tot[c * NWARP + w] = incl;
    if (c == 0) {
      cap0 = (unsigned)cap;
      excl0 = incl - (unsigned)cap;
    }
    mx = max(mx, (unsigned)cap);
  }
  float bv = __int_as_float(0x7f800000);
  int bi = 0x7fffffff;
  for (int r = tid; r < Nr; r += NT) {
    const int q = rowq_of(k, a, r);
    const bool fr = row_info(k, V, r) < 0 && rank_ok(s, I, P, q) && (s.rank_bits[q] & P.narrow & I.rank_fits[q]) != 0;
    const float v = fr ? row_key(k, V, r) : BIGF;
    if (v < bv || (v == bv && r < bi)) { bv = v; bi = r; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    if (ov < bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
  }
  mx = __reduce_max_sync(FULL, mx);
  if (lane == 0) {
    s.xa_v[b1][w] = bv;
    s.xa_i[b1][w] = bi;
    s.xmax[b1][w] = mx;
  }
  __syncthreads();
  ++xc;

  // -- gprefix, second half: each slot's exclusive prefix and its take.
  //    Every warp combines the NWARP per-warp results with shuffles.
  float ov = lane < NWARP ? s.xa_v[b1][lane] : __int_as_float(0x7f800000);
  int o = lane < NWARP ? s.xa_i[b1][lane] : 0x7fffffff;
  unsigned mxall = lane < NWARP ? s.xmax[b1][lane] : 0u;
  for (int off = NWARP / 2; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(FULL, ov, off);
    const int oi = __shfl_xor_sync(FULL, o, off);
    if (v < ov || (v == ov && oi < o)) { ov = v; o = oi; }
    mxall = max(mxall, __shfl_xor_sync(FULL, mxall, off));
  }
  o = __shfl_sync(FULL, o, 0);
  mxall = __shfl_sync(FULL, mxall, 0);
  unsigned run = 0, local = 0;
  for (int c = 0; c < nch; ++c) {
    // the chunk's warp totals scanned across lanes 0..NWARP-1
    const unsigned t = lane < NWARP ? tot[c * NWARP + lane] : 0u;
    unsigned tincl = t;
    for (int off = 1; off < NWARP; off <<= 1) {
      const unsigned u = __shfl_up_sync(FULL, tincl, off);
      if (lane >= off) tincl += u;
    }
    const unsigned pre_w = __shfl_sync(FULL, tincl - t, w);
    const unsigned ctot = __shfl_sync(FULL, tincl, NWARP - 1);
    const int j = c * NT + tid;
    const unsigned cap = c == 0 ? cap0 : (j < oc0 ? (unsigned)tk_at(k, j) : 0u);
    const unsigned excl = c == 0 ? excl0 : warp_incl_scan(cap, lane) - cap;
    const unsigned pre = run + pre_w + excl;
    if (j < oc0) {
      const int x = wsub(P.cnt, (int)pre);
      const int take = min(max(x, 0), (int)cap);
      tk_at(k, j) = take;
      local += (unsigned)take;
    }
    run += ctot;
  }

  // -- gsum: the take total. Without int32 wraparound in any prefix the
  //    first-fit takes sum to min(cnt, total capacity); else exchange them.
  unsigned sum;
  if (P.cnt >= 0 && (unsigned long long)mxall * (unsigned long long)oc0 < (1ull << 31)) {
    sum = (unsigned)min(P.cnt, (int)run);
  } else {
    local = __reduce_add_sync(FULL, local);
    const int b2 = xc & 1;
    if (lane == 0) s.xred[b2][w] = local;
    __syncthreads();
    ++xc;
    sum = 0;
    for (int ww = 0; ww < NWARP; ++ww) sum += s.xred[b2][ww];
  }
  const int left = wsub(P.cnt, (int)sum);

  // -- the best row and how many fresh slots of it (every thread, same values)
  const int q = rowq_of(k, a, o);
  const int ro = row_info(k, V, o);
  const bool o_ok = ro < 0 && rank_ok(s, I, P, q) && (s.rank_bits[q] & P.narrow & I.rank_fits[q]) != 0;
  int cap_open = 0;
  const uint32_t newzs = s.rank_bits[q] & P.narrow;
  for (uint32_t sel = newzs; sel; sel &= sel - 1) cap_open = max(cap_open, V.opencap[q * a.D + __ffs(sel) - 1]);
  const int cstar = min(min(min(ro & 0x7fffffff, cap_open), I.host_cap_new), I.port_cap);
  const bool can_open = o_ok && cstar >= 1;
  int m = can_open ? wsub(0, floordiv(wsub(0, left), max(cstar, 1))) : 0;
  m = min(max(m, 0), a.N - oc0);

  // -- update: the takes of the open slots, then the fresh slots
  const int hi = oc0 + m;
  const int o_rank = row_rank(k, a, o);
  uint32_t opa, opw, ops;
  row_ports(k, a, o, opa, opw, ops);
  uint32_t blocked = 0;
  for (int base = 0; base < hi; base += NT) {
    const int j = base + tid;
    if (j >= hi) continue;
    int take = j < oc0 ? tk_at(k, j) : 0;
    if (j >= oc0) {
      const int x = wsub(left, wmul(j - oc0, cstar));
      take += min(max(x, 0), cstar);
      basis_at(k, a, j) = o;
      rank_at(k, a, j) = o_rank;
      for (int r = 0; r < R; ++r) rem_at(k, a, j, r) = a.row_alloc[(size_t)o * R + r];
      zs_at(k, j) = newzs;
      pa_at(k, j) = opa;
      pw_at(k, j) = opw;
      ps_at(k, j) = ops;
    }
    if (take > 0) {
      const uint32_t z = zs_at(k, j) & P.narrow;
      zs_at(k, j) = z;
      const float tf = (float)take;
#pragma unroll 4
      for (int r = 0; r < R; ++r) {
        float& v = rem_at(k, a, j, r);
        v = __fsub_rn(v, __fmul_rn(tf, I.req[r]));
      }
      for (int t = 0; t < I.n_hmem; ++t) {
        int* ch = a.counts_host + (size_t)I.hmem[t] * a.N + j;
        *ch = wadd(*ch, take);
      }
      pa_at(k, j) |= I.pany;
      pw_at(k, j) |= I.pwild;
      ps_at(k, j) |= I.pspec;
      add_take(k, a, i, j, take);
      blocked |= z;
    }
  }
  // the fresh slots take min(left, m * cstar) in all: each takes cstar but
  // the last, and (m - 1) * cstar < left keeps every term exact
  const int new_sum = m > 0 ? (int)min((long long)left, (long long)m * cstar) : 0;
  oc = wadd(oc0, m);
  Placed res;
  res.left = wsub(left, new_sum);
  res.blocked = P.want_blocked ? gany_slots(s, blocked, xc) : 0u;
  return res;
}

// -- per-item prologue (warp 0) -----------------------------------------------

__device__ __forceinline__ void item_prologue(const Ctx& k, const PackArgs& a, const Smem& s, int i, ItemSm& I, int* opencap) {
  const int lane = threadIdx.x & 31;
  const int D = a.D, G = a.G, Q = a.Q, R = a.R, Kd = a.Kd;
  const uint32_t lt = (1u << lane) - 1u;
  __syncwarp();
  if (lane < R) I.req[lane] = a.item_req[(size_t)i * R + lane];
  const uint32_t za = __ballot_sync(FULL, lane < D && a.item_dom_allowed[(size_t)i * D + lane] != 0);
  const uint32_t rs = __ballot_sync(FULL, lane < Kd && a.item_restrict[(size_t)i * Kd + lane] != 0);
  const uint32_t pa = __ballot_sync(FULL, lane < a.P1 && a.item_port_any[(size_t)i * a.P1 + lane] != 0);
  const uint32_t pw = __ballot_sync(FULL, lane < a.P1 && a.item_port_wild[(size_t)i * a.P1 + lane] != 0);
  const uint32_t ps = __ballot_sync(FULL, lane < a.P2 && a.item_port_spec[(size_t)i * a.P2 + lane] != 0);
  int n_zmm = 0, n_hown = 0, n_hmem = 0, n_haff = 0, kstar = -1, hcap = INF_I;
  bool anti = false, domaff = false, hostaff = false;
  for (int g0 = 0; g0 < G; g0 += 32) {
    const int g = g0 + lane;
    const bool in = g < G;
    const bool mem = in && a.item_member[(size_t)i * G + g] != 0;
    const bool own = in && a.item_owner[(size_t)i * G + g] != 0;
    const int kind = in ? a.group_kind[g] : -1;
    const bool zm = mem && (kind == K_DOM_SPREAD || kind == K_DOM_ANTI || kind == K_DOM_AFF);
    const bool ho = own && (kind == K_HOST_SPREAD || kind == K_HOST_ANTI);
    const bool hm = mem && (kind == K_HOST_SPREAD || kind == K_HOST_ANTI || kind == K_HOST_AFF);
    const bool ha = own && kind == K_HOST_AFF;
    uint32_t b = __ballot_sync(FULL, zm);
    if (zm) I.zmm[n_zmm + __popc(b & lt)] = (uint8_t)g;
    n_zmm += __popc(b);
    b = __ballot_sync(FULL, ho);
    if (ho) I.hown[n_hown + __popc(b & lt)] = (uint8_t)g;
    n_hown += __popc(b);
    b = __ballot_sync(FULL, hm);
    if (hm) I.hmem[n_hmem + __popc(b & lt)] = (uint8_t)g;
    n_hmem += __popc(b);
    b = __ballot_sync(FULL, ha);
    if (ha) I.haff[n_haff + __popc(b & lt)] = (uint8_t)g;
    n_haff += __popc(b);
    kstar = max(kstar, __reduce_max_sync(FULL, zm ? a.group_dom_key[g] : -1));
    hcap = min(hcap, __reduce_min_sync(FULL, ho ? (kind == K_HOST_SPREAD ? a.group_skew[g] : 1) : INF_I));
    anti |= __any_sync(FULL, zm && kind == K_DOM_ANTI);
    domaff |= __any_sync(FULL, zm && kind == K_DOM_AFF);
    hostaff |= __any_sync(FULL, mem && kind == K_HOST_AFF);
  }
  const uint32_t km = __ballot_sync(FULL, lane < D && a.dom_key_of[lane] == kstar);
  const uint32_t rs_other = (kstar >= 0 && kstar < 32) ? (rs & ~(1u << kstar)) : rs;
  const uint32_t ok_all = __ballot_sync(FULL, lane < Q && perkey_ok(s, za, s.rank_bits[lane], rs));
  const uint32_t ok_other = __ballot_sync(FULL, lane < Q && perkey_ok(s, za, s.rank_bits[lane], rs_other));
  __syncwarp();  // req
  for (int e = lane; e < Q * D; e += 32) opencap[e] = int_cap(k.rdcap + (size_t)e * R, I.req, R);
  __syncwarp();  // open caps
  uint32_t rank_fits = 0;
  if (lane < Q) {
    for (int d = 0; d < D; ++d) rank_fits |= (uint32_t)(opencap[lane * D + d] >= 1) << d;
    I.rank_fits[lane] = rank_fits;
  }
  // rows: fits (sign bit) and capacity of a fresh slot, the compat bits, the
  // domains a fresh slot could open in; host-blocked bits of the existing
  // slots
  const int Nr = a.Nrows;
  uint32_t openable = 0;
  for (int r0 = 0; r0 < Nr; r0 += 32) {
    const int r = r0 + lane;
    const bool in = r < Nr;
    const bool c = in && a.compat[(size_t)i * Nr + r] != 0;
    const uint32_t cb = __ballot_sync(FULL, c);
    if (lane == 0) k.g_cbits[(size_t)i * k.nrw + (r0 >> 5)] = cb;
    const int q = in ? rowq_of(k, a, r) : 0;
    const uint32_t rf = __shfl_sync(FULL, rank_fits, q);
    if (in) {
      bool fits = c && r >= a.n_existing && r < a.n_rows_real;
#pragma unroll 4
      for (int kk = 0; kk < R; ++kk) fits = fits && I.req[kk] <= a.row_alloc[(size_t)r * R + kk];
      uint32_t rpa, rpw, rps;
      row_ports(k, a, r, rpa, rpw, rps);
      fits = fits && ((rpa & pw) | (rpw & pa) | (rps & ps)) == 0;
      k.g_rowinfo[(size_t)i * Nr + r] = int_cap(a.row_alloc + (size_t)r * R, I.req, R) | (fits ? (int)0x80000000 : 0);
      if (fits && ((ok_other >> q) & 1u)) openable |= s.rank_bits[q] & rf;
    }
  }
  const int n_blk = min(a.n_existing, a.N);
  for (int j0 = 0; j0 < n_blk; j0 += 32) {
    const int j = j0 + lane;
    const bool b = j < n_blk && a.item_host_blocked[(size_t)i * a.HB + clampi(j, 0, a.HB - 1)] != 0;
    const uint32_t hb = __ballot_sync(FULL, b);
    if (lane == 0) k.g_hbw[(size_t)i * k.nb + (j0 >> 5)] = hb;
  }
  openable = __reduce_or_sync(FULL, openable);
  if (lane == 0) {
    I.za = za;
    I.kmask = km;
    I.restrict_all = rs;
    I.restrict_other = rs_other;
    I.pany = pa;
    I.pwild = pw;
    I.pspec = ps;
    I.rank_ok_all = ok_all;
    I.rank_ok_other = ok_other;
    I.openable = openable;
    I.c = a.item_count[i];
    I.port_cap = pa ? 1 : INF_I;
    I.host_cap_new = hcap;
    I.branch = hostaff ? 4 : domaff ? 3 : anti ? 2 : (n_zmm > 0 ? 1 : 0);
    I.n_zmm = n_zmm;
    I.n_hown = n_hown;
    I.n_hmem = n_hmem;
    I.n_haff = n_haff;
  }
}

// -- thread-0 helpers of the zone branch ---------------------------------------

__device__ __forceinline__ uint32_t spread_ok_bits(const PackArgs& a, const Smem& s, const ItemSm& I) {
  const int D = a.D;
  uint32_t ok = full_mask(D);
  for (int t = 0; t < I.n_zmm; ++t) {
    int g = I.zmm[t];
    uint32_t reg = s.reg_bits[g], zr = I.za & reg;
    const int* cz = a.counts_zone + (size_t)g * D;
    int zmin = INF_I;
    for (int d = 0; d < D; ++d)
      if ((zr >> d) & 1u) zmin = min(zmin, cz[d]);
    if (zmin >= INF_I) zmin = 0;
    int md = a.group_min_domains[g];
    if (md > 0 && __popc(zr) < md) zmin = 0;
    bool anti = a.group_kind[g] == K_DOM_ANTI;
    for (int d = 0; d < D; ++d) {
      bool pg = anti ? cz[d] == 0 : wsub(wadd(cz[d], 1), zmin) <= a.group_skew[g];
      if (!(pg && ((reg >> d) & 1u))) ok &= ~(1u << d);
    }
  }
  return ok;
}

// integer water-fill (2Z+2 rounds, then the remainder to the lowest-index
// minimum entries); v/cap over D entries, result into s.inc
__device__ __forceinline__ void waterfill(const PackArgs& a, Smem& s, const int* v, uint32_t finite, int c, const int* cap) {
  const int D = a.D;
  float* vf = s.wv;
  int* capf = s.wcap;
  int* inc = s.inc;
  for (int d = 0; d < D; ++d) {
    vf[d] = ((finite >> d) & 1u) ? (float)v[d] : BIGF;
    capf[d] = clampi(cap[d], 0, INF_I);
    inc[d] = 0;
  }
  int rem = c;
  for (int it = 0; it < 2 * D + 2; ++it) {
    uint32_t act = 0;
    float m = BIGF;
    for (int d = 0; d < D; ++d) {
      bool ac = ((finite >> d) & 1u) && inc[d] < capf[d];
      act |= (uint32_t)ac << d;
      m = fminf(m, ac ? __fadd_rn(vf[d], (float)inc[d]) : BIGF);
    }
    int kmin = 0, headroom = INF_I;
    float nxt = BIGF;
    for (int d = 0; d < D; ++d) {
      bool ac = (act >> d) & 1u;
      float cur = ac ? __fadd_rn(vf[d], (float)inc[d]) : BIGF;
      if (cur == m && ac) { kmin++; headroom = min(headroom, capf[d] - inc[d]); }
      if (cur > m) nxt = fminf(nxt, cur);
    }
    float gap = nxt < BIGF / 2 ? __fsub_rn(nxt, m) : BIGF;
    float quota = floorf(__fdiv_rn((float)rem, (float)max(kmin, 1)));
    int dd = (int)fminf(fminf(gap, (float)headroom), quota);
    dd = kmin > 0 ? max(dd, 0) : 0;
    for (int d = 0; d < D; ++d) {
      bool ac = (act >> d) & 1u;
      if (ac && __fadd_rn(vf[d], (float)inc[d]) == m) inc[d] = wadd(inc[d], dd);
    }
    rem = wsub(rem, wmul(dd, kmin));
  }
  uint32_t act = 0;
  float m = BIGF;
  for (int d = 0; d < D; ++d) {
    bool ac = ((finite >> d) & 1u) && inc[d] < capf[d];
    act |= (uint32_t)ac << d;
    m = fminf(m, ac ? __fadd_rn(vf[d], (float)inc[d]) : BIGF);
  }
  int pos = 0;
  for (int d = 0; d < D; ++d) {
    bool ac = (act >> d) & 1u;
    if (ac && __fadd_rn(vf[d], (float)inc[d]) == m) {
      if (pos < rem) inc[d] += 1;
      pos++;
    }
    if (!((finite >> d) & 1u)) inc[d] = 0;
  }
}

// joint multi-group water-fill over the item's keyed member groups
__device__ __forceinline__ void waterfill_multi(const PackArgs& a, Smem& s, const ItemSm& I, uint32_t avail, int c) {
  const int D = a.D, ng = I.n_zmm;
  const int m = max(ng, 1);
  int* fz = s.wf_a;
  int* pg = s.wf_b;
  int* ug = s.wf_c;
  int* inc = s.inc;
  int* lvl = s.lvl;
  int* react = s.react;
  for (int t = 0; t < ng; ++t) {
    int g = I.zmm[t];
    int md = a.group_min_domains[g];
    fz[t] = md > 0 && __popc(s.reg_bits[g] & I.za) < md;
  }
  for (int d = 0; d < D; ++d) inc[d] = 0;
  int rem = c;
#define CG(t, d) (a.counts_zone[(size_t)I.zmm[t] * D + (d)] + inc[d])
  while (rem > 0) {
    uint32_t ok = full_mask(D);
    for (int d = 0; d < D; ++d) lvl[d] = 0;
    for (int t = 0; t < ng; ++t) {
      int g = I.zmm[t];
      uint32_t reg = s.reg_bits[g], regm = reg & I.za;
      int zmin = INF_I;
      for (int d = 0; d < D; ++d)
        if ((regm >> d) & 1u) zmin = min(zmin, CG(t, d));
      if (zmin >= INF_I) zmin = 0;
      if (fz[t]) zmin = 0;
      uint32_t okg = 0;
      for (int d = 0; d < D; ++d) {
        int cg = CG(t, d);
        if (cg + 1 - zmin <= a.group_skew[g] && ((reg >> d) & 1u)) okg |= 1u << d;
        lvl[d] += cg;
      }
      s.wf_ok[t] = okg;
      ok &= okg;
    }
    uint32_t active = avail & ok;
    int mlvl = INF_I;
    for (int d = 0; d < D; ++d)
      if ((active >> d) & 1u) mlvl = min(mlvl, lvl[d]);
    uint32_t is_min = 0;
    for (int d = 0; d < D; ++d)
      if (((active >> d) & 1u) && lvl[d] == mlvl) is_min |= 1u << d;
    int kmin = __popc(is_min);
    if (kmin == 0) break;
    int nxt = INF_I;
    for (int d = 0; d < D; ++d)
      if (((active >> d) & 1u) && lvl[d] > mlvl) nxt = min(nxt, lvl[d]);
    int d_gap = nxt < INF_I ? -floordiv(-(nxt - mlvl), m) : INF_I;
    int d_head = INF_I;
    for (int t = 0; t < ng; ++t) {
      int g = I.zmm[t];
      uint32_t regm = s.reg_bits[g] & I.za;
      int p = INF_I, u = INF_I;
      for (int d = 0; d < D; ++d) {
        if (!((regm >> d) & 1u)) continue;
        if ((is_min >> d) & 1u) p = min(p, CG(t, d));
        else u = min(u, CG(t, d));
      }
      if (fz[t]) u = 0;
      pg[t] = p;
      ug[t] = u;
      for (int d = 0; d < D; ++d)
        if ((is_min >> d) & 1u) d_head = min(d_head, u < INF_I ? a.group_skew[g] + u - CG(t, d) : INF_I);
    }
    uint32_t reg_all = full_mask(D);
    for (int d = 0; d < D; ++d) {
      int rmax = 0;
      bool inf = false;
      for (int t = 0; t < ng; ++t) {
        int g = I.zmm[t];
        bool blocking = !((s.wf_ok[t] >> d) & 1u) && ((s.reg_bits[g] >> d) & 1u);
        if (!blocking) continue;
        int thr = CG(t, d) + 1 - a.group_skew[g];
        int kk = (ug[t] >= thr && pg[t] < INF_I && !fz[t]) ? max(thr - pg[t], 1) : INF_I;
        rmax = max(rmax, kk);
        if (kk >= INF_I) inf = true;
      }
      react[d] = inf ? INF_I : rmax;
    }
    for (int t = 0; t < ng; ++t) reg_all &= s.reg_bits[I.zmm[t]];
    uint32_t rejoinable = avail & ~ok & reg_all;
    int d_react = INF_I;
    for (int d = 0; d < D; ++d) {
      if (!((rejoinable >> d) & 1u)) continue;
      int rc = min(react[d], 1 << 20);
      bool mid = lvl[d] < min(mlvl, 1 << 20) + (rc - 1) * m;
      int safe = react[d] >= INF_I ? INF_I : (mid ? react[d] - 1 : react[d]);
      d_react = min(d_react, safe);
    }
    bool partial = rem < kmin || d_react < 1;
    int dd = min(min(d_gap, d_head), min(d_react, floordiv(rem, max(kmin, 1))));
    dd = max(dd, 1);
    if (partial) {
      inc[__ffs(is_min) - 1] += 1;
      rem -= 1;
    } else {
      for (int d = 0; d < D; ++d)
        if ((is_min >> d) & 1u) inc[d] += dd;
      rem = wsub(rem, wmul(dd, kmin));
    }
  }
#undef CG
}

__device__ __forceinline__ uint32_t narrow_of(const ItemSm& I, int z) {
  return (I.kmask & (1u << z)) | (I.za & ~I.kmask);
}

__device__ __forceinline__ Place mk_place(int cnt, int el, uint32_t elbits, uint32_t restrict_mask, uint32_t narrow,
                                          int rk, uint32_t rkbits, bool want_blocked = false) {
  Place p;
  p.cnt = cnt;
  p.el = el;
  p.elbits = elbits;
  p.restrict_mask = restrict_mask;
  p.narrow = narrow;
  p.rk = rk;
  p.rkbits = rkbits;
  p.want_blocked = want_blocked;
  return p;
}

// thread 0 publishes an int and two masks to every thread (one barrier)
__device__ __forceinline__ void publish(Smem& s, int& pc, int& v, uint32_t& u0, uint32_t& u1) {
  const int b = pc & 1;
  if (threadIdx.x == 0) {
    s.pub_i[b] = v;
    s.pub_u[b][0] = u0;
    s.pub_u[b][1] = u1;
  }
  __syncthreads();
  ++pc;
  v = s.pub_i[b];
  u0 = s.pub_u[b][0];
  u1 = s.pub_u[b][1];
}

// -- the kernel ----------------------------------------------------------------

// one item's record, open caps, rows, compat and host-blocked bits into
// buffer b by asynchronous copies (the caller waits before its barrier)
__device__ __forceinline__ void prefetch_item(const Ctx& k, const PackArgs& a, Smem& s, int i, int b) {
  const int tid = threadIdx.x, QD = a.Q * a.D, Nr = a.Nrows;
  const int4* rec = reinterpret_cast<const int4*>(k.g_recs + i);
  int4* dst = reinterpret_cast<int4*>(&s.it[b]);
  for (int c = tid; c < REC_WORDS / 4; c += NT) cp_async16(dst + c, rec + c);
  for (int e = tid; e < QD; e += NT) cp_async4(k.opencap + (size_t)b * QD + e, k.g_opencap + (size_t)i * QD + e);
  for (int r = tid; r < k.rt; r += NT) {
    cp_async4(k.rowinfo + (size_t)b * k.rt + r, k.g_rowinfo + (size_t)i * Nr + r);
    cp_async4(k.rowkey + (size_t)b * k.rt + r, a.choose_key + (size_t)i * Nr + r);
  }
  for (int e = tid; e < k.nrw; e += NT) cp_async4(k.cbits + (size_t)b * k.nrw + e, k.g_cbits + (size_t)i * k.nrw + e);
  for (int e = tid; e < k.nb; e += NT) cp_async4(k.hbw + (size_t)b * k.nb + e, k.g_hbw + (size_t)i * k.nb + e);
}

__global__ void __launch_bounds__(NT, 1) pack_scan_kernel(PackArgs a) {
  __shared__ Smem s;
  extern __shared__ __align__(16) uint32_t dyn[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int N = a.N, D = a.D, G = a.G, R = a.R, Q = a.Q, Nr = a.Nrows, W = a.W;
  const Layout L = layout_of(N, Nr, R, Q, D, a.n_existing);
  const Scratch S = scratch_of(W, N, Nr, Q, D, a.n_existing);
  Ctx k;
  k.tile = L.tile;
  k.rt = L.rt;
  k.nch = L.nch;
  k.nrw = L.nrw;
  k.nb = L.nb;
  k.sb = (int*)(dyn + L.basis);
  k.sr = (int*)(dyn + L.rank);
  k.szs = dyn + L.zs;
  k.spa = dyn + L.pa;
  k.spw = dyn + L.pw;
  k.sps = dyn + L.ps;
  k.stk = (int*)(dyn + L.tk);
  k.stki = (int*)(dyn + L.tki);
  k.stkv = (int*)(dyn + L.tkv);
  k.srem = (float*)(dyn + L.rem);
  k.rowrank = (int*)(dyn + L.rowrank);
  k.rpa = dyn + L.rpa;
  k.rpw = dyn + L.rpw;
  k.rps = dyn + L.rps;
  k.dcls = dyn + L.dcls;
  k.rdcap = (float*)(dyn + L.rdcap);
  k.opencap = (int*)(dyn + L.opencap);
  k.rowinfo = (int*)(dyn + L.rowinfo);
  k.rowkey = (float*)(dyn + L.rowkey);
  k.cbits = dyn + L.cbits;
  k.hbw = dyn + L.hbw;
  k.xtot = dyn + L.xtot;
  uint32_t* scratch = (uint32_t*)a.scratch;
  k.gzs = scratch + S.far;
  k.gpa = k.gzs + N;
  k.gpw = k.gpa + N;
  k.gps = k.gpw + N;
  k.gtk = (int*)(k.gps + N);
  k.g_recs = reinterpret_cast<ItemSm*>(scratch + S.recs);
  k.g_opencap = (int*)(scratch + S.opencap);
  k.g_rowinfo = (int*)(scratch + S.rowinfo);
  k.g_cbits = scratch + S.cbits;
  k.g_hbw = scratch + S.hbw;

  // constants: key, rank and registration masks, group kinds and skews; the
  // row tile's ranks and port masks; the rank caps
  for (int kk = tid; kk < a.Kd; kk += NT) {
    uint32_t km = 0;
    for (int d = 0; d < D; ++d) km |= (uint32_t)(a.dom_key_of[d] == kk) << d;
    s.keymask[kk] = km;
  }
  for (int q = tid; q < Q; q += NT) {
    uint32_t b = 0;
    for (int d = 0; d < D; ++d) b |= (uint32_t)(a.rank_domset[q * D + d] != 0) << d;
    s.rank_bits[q] = b;
  }
  for (int g = tid; g < G; g += NT) {
    uint32_t b = 0;
    for (int d = 0; d < D; ++d) b |= (uint32_t)(a.group_registered[g * D + d] != 0) << d;
    s.reg_bits[g] = b;
    s.gkind[g] = a.group_kind[g];
    s.gskew[g] = a.group_skew[g];
  }
  for (int r = tid; r < k.rt; r += NT) {
    row_port_masks(a, r, k.rpa[r], k.rpw[r], k.rps[r]);
    k.rowrank[r] = a.row_pool_rank[r];
  }
  for (int e = tid; e < Q * D * R; e += NT) k.rdcap[e] = a.rank_dom_cap[e];
  for (int e = tid; e < Q * D; e += NT) {
    const float* mine = a.rank_dom_cap + (size_t)e * R;
    const float* row0 = a.rank_dom_cap + (size_t)(e / D) * D * R;
    uint32_t cls = 0;
    for (int d = 0; d < D; ++d) {
      bool same = true;
      for (int r = 0; r < R; ++r) same = same && __float_as_int(row0[d * R + r]) == __float_as_int(mine[r]);
      cls |= (uint32_t)same << d;
    }
    k.dcls[e] = cls;
  }

  // blocks 1.. build what an item needs that does not depend on the carry,
  // for all items, one warp per item (`item_prologue`), and count
  // themselves done; block 0 runs the scan
  unsigned* done = scratch + S.done;
  if (blockIdx.x > 0) {
    __syncthreads();  // the constants
    const int stride = (gridDim.x - 1) * NWARP;
    for (int i = (blockIdx.x - 1) * NWARP + warp; i < W; i += stride)
      item_prologue(k, a, s, i, k.g_recs[i], k.g_opencap + (size_t)i * Q * D);
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(done, 1u);
    return;
  }

  // the open slots' state: the tile into shared memory, domain and port
  // planes into masks
  int oc = a.open_count[0];
  const int oc_in = min(oc, N);
  for (int j = tid; j < k.tile; j += NT) k.stki[j] = -1;
  for (int j = tid; j < oc_in; j += NT) {
    uint32_t z = 0, pa = 0, pw = 0, ps = 0;
    for (int d = 0; d < D; ++d) z |= (uint32_t)(a.slot_zoneset[(size_t)j * D + d] != 0) << d;
    for (int p = 0; p < a.P1; ++p) {
      pa |= (uint32_t)(a.slot_pany[(size_t)j * a.P1 + p] != 0) << p;
      pw |= (uint32_t)(a.slot_pwild[(size_t)j * a.P1 + p] != 0) << p;
    }
    for (int p = 0; p < a.P2; ++p) ps |= (uint32_t)(a.slot_pspec[(size_t)j * a.P2 + p] != 0) << p;
    zs_at(k, j) = z;
    pa_at(k, j) = pa;
    pw_at(k, j) = pw;
    ps_at(k, j) = ps;
    if (j < k.tile) {
      k.sb[j] = a.slot_basis[j];
      k.sr[j] = a.slot_rank[j];
      for (int r = 0; r < R; ++r) k.srem[(size_t)r * k.tile + j] = a.slot_rem[(size_t)j * R + r];
    }
  }
  __syncthreads();

  // wait for the item blocks (co-resident: the launch is cooperative); a
  // block that never ran would trap here instead of hanging the card
  if (tid == 0) {
    const long long t0 = clock64();
    while (atomicAdd(done, 0u) < gridDim.x - 1) {
      __nanosleep(256);
      if (clock64() - t0 > (1LL << 34)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
  if (W > 0) prefetch_item(k, a, s, 0, 0);
  cp_async_wait_all();
  __syncthreads();

  int xc = 0, pc = 0;
  for (int i = 0; i < W; ++i) {
    const int bi = i & 1;
    if (i + 1 < W) prefetch_item(k, a, s, i + 1, bi ^ 1);  // lands while item i runs
    const ItemSm& I = s.it[bi];
    const ItemView V{I, k.opencap + (size_t)bi * Q * D, k.rowinfo + (size_t)bi * k.rt, k.rowkey + (size_t)bi * k.rt,
                     k.cbits + (size_t)bi * k.nrw, k.hbw + (size_t)bi * k.nb, k.g_rowinfo + (size_t)i * Nr,
                     a.choose_key + (size_t)i * Nr};

    int pending;
    const int branch = I.branch;
    if (branch == 0) {
      // simple path
      pending = place(k, a, s, V, mk_place(I.c, EL_ALL, 0, I.restrict_all, I.za, RK_ALL, 0), i, oc, xc).left;
    } else if (branch == 1) {
      // zone path: slot capacity per domain, water-fill, per-domain fill and
      // redistribution of stranded quota
      uint32_t sl = 0;
      for (int j = tid; j < oc; j += NT) {
        if (slot_compat(k, a, V, j) && int_cap_slot(k, a, j, I.req) > 0 && port_ok(k, I, j) &&
            perkey_ok(s, I.za, zs_at(k, j), I.restrict_other))
          sl |= zs_at(k, j);
      }
      uint32_t slotcap = gany_slots(s, sl, xc);
      // thread 0: the water-fill; zone scalars for the redistribution
      int skew_star = INF_I, multi = I.n_zmm > 1, force_zero = 0;
      uint32_t allowed_real = 0, available = 0, finite = 0, reg_all = full_mask(D);
      if (tid == 0) {
        int md_star = 0;
        uint32_t reg_star = 0;
        for (int d = 0; d < D; ++d) s.vsum[d] = 0;
        for (int t = 0; t < I.n_zmm; ++t) {
          int g = I.zmm[t];
          for (int d = 0; d < D; ++d) s.vsum[d] = wadd(s.vsum[d], a.counts_zone[(size_t)g * D + d]);
          if (a.group_kind[g] == K_DOM_SPREAD) skew_star = min(skew_star, a.group_skew[g]);
          reg_star |= s.reg_bits[g];
          reg_all &= s.reg_bits[g];
          md_star = max(md_star, a.group_min_domains[g]);
        }
        allowed_real = I.za & reg_star & I.kmask;
        available = allowed_real & (I.openable | slotcap);
        finite = available & (multi ? spread_ok_bits(a, s, I) : 0xffffffffu);
        uint32_t frozen = allowed_real & ~available;
        int frozen_min = INF_I;
        for (int d = 0; d < D; ++d)
          if ((frozen >> d) & 1u) frozen_min = min(frozen_min, s.vsum[d]);
        int supported = __popc(I.za & reg_star & I.kmask);
        force_zero = md_star > 0 && supported < md_star;
        if (force_zero) frozen_min = 0;
        for (int d = 0; d < D; ++d) s.capd[d] = clampi(wsub(wadd(frozen_min, skew_star), s.vsum[d]), 0, INF_I);
        if (multi) waterfill_multi(a, s, I, available, I.c);
        else waterfill(a, s, s.vsum, finite, I.c, s.capd);
        for (int d = 0; d < D; ++d) s.placed_z[d] = 0;
      }
      __syncthreads();  // s.inc
      pending = I.c;
      for (int d = 0; d < D; ++d) pending = wsub(pending, s.inc[d]);
      for (int z = 0; z < D; ++z) {
        const int cz = s.inc[z];
        const int left = place(k, a, s, V,
                               mk_place(cz, EL_ZONE, 1u << z, I.restrict_other, narrow_of(I, z), RK_BITS, 1u << z), i,
                               oc, xc).left;
        pending = wadd(pending, left);
        if (tid == 0) s.placed_z[z] = wsub(cz, left);
      }
      for (int z = 0; z < D; ++z) {
        int cz = 0;
        uint32_t u0 = 0, u1 = 0;
        if (tid == 0) {
          int headroom;
          if (multi) {
            int head = INF_I;
            for (int t = 0; t < I.n_zmm; ++t) {
              int g = I.zmm[t];
              uint32_t zr = I.za & s.reg_bits[g];
              int zmin = INF_I;
              for (int d = 0; d < D; ++d)
                if ((zr >> d) & 1u) zmin = min(zmin, wadd(a.counts_zone[(size_t)g * D + d], s.placed_z[d]));
              if (zmin >= INF_I) zmin = 0;
              int md = a.group_min_domains[g];
              if (md > 0 && __popc(zr) < md) zmin = 0;
              int h = wsub(wadd(zmin, a.group_skew[g]), wadd(a.counts_zone[(size_t)g * D + z], s.placed_z[z]));
              head = min(head, h);
            }
            headroom = clampi(((reg_all & available) >> z) & 1u ? head : 0, 0, INF_I);
          } else {
            int zmin = INF_I;
            for (int d = 0; d < D; ++d)
              if ((allowed_real >> d) & 1u) zmin = min(zmin, wadd(s.vsum[d], s.placed_z[d]));
            if (zmin >= INF_I) zmin = 0;
            if (force_zero) zmin = 0;
            int h = clampi(wsub(wadd(zmin, skew_star), wadd(s.vsum[z], s.placed_z[z])), 0, INF_I);
            headroom = ((finite >> z) & 1u) ? h : 0;
          }
          cz = min(pending, headroom);
        }
        publish(s, pc, cz, u0, u1);
        const int left = place(k, a, s, V,
                               mk_place(cz, EL_ZONE, 1u << z, I.restrict_other, narrow_of(I, z), RK_BITS, 1u << z), i,
                               oc, xc).left;
        const int placed = wsub(cz, left);
        pending = wsub(pending, placed);
        if (tid == 0) s.placed_z[z] = wadd(s.placed_z[z], placed);
      }
      if (tid == 0) {
        for (int t = 0; t < I.n_zmm; ++t)
          for (int d = 0; d < D; ++d) {
            int* p = a.counts_zone + (size_t)I.zmm[t] * D + d;
            *p = wadd(*p, s.placed_z[d]);
          }
      }
    } else if (branch == 2) {
      // keyed anti-affinity: D+1 single-pod rounds, each placement blocks
      // every domain its slot could still land in
      uint32_t reg_star = 0;
      for (int t = 0; t < I.n_zmm; ++t) reg_star |= s.reg_bits[I.zmm[t]];
      pending = I.c;
      for (int round = 0; round <= D; ++round) {
        int unused = 0;
        uint32_t empty = 0, narrow = 0;
        if (tid == 0) {
          for (int d = 0; d < D; ++d) {
            int v = 0;
            for (int t = 0; t < I.n_zmm; ++t) v = wadd(v, a.counts_zone[(size_t)I.zmm[t] * D + d]);
            if (v == 0) empty |= 1u << d;
          }
          empty &= reg_star & I.za & I.kmask;
          narrow = (I.kmask & empty) | (~I.kmask & I.za);
        }
        publish(s, pc, unused, empty, narrow);
        const int cnt = min(pending, 1);
        const Placed r = place(k, a, s, V, mk_place(cnt, EL_ANTI, empty, I.restrict_other, narrow, RK_BITS, empty, true),
                               i, oc, xc);
        if (tid == 0) {
          uint32_t blocked = r.blocked & I.kmask;
          for (int t = 0; t < I.n_zmm; ++t)
            for (int d = 0; d < D; ++d)
              if ((blocked >> d) & 1u) {
                int* p = a.counts_zone + (size_t)I.zmm[t] * D + d;
                *p = wadd(*p, 1);
              }
        }
        pending = wsub(pending, wsub(cnt, r.left));
      }
    } else if (branch == 3) {
      // required affinity over a domain key: recorded domains, else one
      // bootstrap domain
      int n_aff = 0;
      uint32_t allowed_rec = 0, bootstrapable = 0;
      if (tid == 0) {
        uint32_t reg_star = 0, rec = 0;
        for (int d = 0; d < D; ++d) s.vsum[d] = 0;
        for (int t = 0; t < I.n_zmm; ++t) {
          int g = I.zmm[t];
          if (a.group_kind[g] != K_DOM_AFF) continue;
          s.wf_a[n_aff++] = g;
          reg_star |= s.reg_bits[g];
          for (int d = 0; d < D; ++d) s.vsum[d] = wadd(s.vsum[d], a.counts_zone[(size_t)g * D + d]);
        }
        for (int d = 0; d < D; ++d)
          if (s.vsum[d] > 0) rec |= 1u << d;
        allowed_rec = I.za & I.kmask & reg_star & rec;
        bootstrapable = I.za & I.kmask & reg_star;
        for (int d = 0; d < D; ++d) s.placed_z[d] = 0;
      }
      publish(s, pc, n_aff, allowed_rec, bootstrapable);
      const bool any_rec = allowed_rec != 0;
      int boot = -1;
      pending = I.c;
      for (int z = 0; z < D; ++z) {
        const bool active = any_rec ? ((allowed_rec >> z) & 1u) != 0
                                    : (boot >= 0 ? boot == z : ((bootstrapable >> z) & 1u) != 0);
        const int cnt = active ? pending : 0;
        const int left = place(k, a, s, V,
                               mk_place(cnt, EL_ZONE, 1u << z, I.restrict_other, narrow_of(I, z), RK_BITS, 1u << z), i,
                               oc, xc).left;
        const int placed = wsub(cnt, left);
        pending = wsub(pending, placed);
        if (tid == 0) s.placed_z[z] = wadd(s.placed_z[z], placed);
        if (!any_rec && boot < 0 && placed > 0) boot = z;
      }
      if (tid == 0) {
        for (int t = 0; t < n_aff; ++t)
          for (int d = 0; d < D; ++d) {
            int* p = a.counts_zone + (size_t)s.wf_a[t] * D + d;
            *p = wadd(*p, s.placed_z[d]);
          }
      }
    } else {
      // required hostname affinity: recorded hosts, else one bootstrap host.
      // Without owned affinity groups every slot counts as recorded.
      bool any_rec;
      if (I.n_haff == 0) {
        any_rec = N > 0;
      } else {
        uint32_t rec = 0;
        for (int j = tid; j < oc; j += NT) rec |= rec_ok(a, I, j) ? 1u : 0u;
        any_rec = gany_slots(s, rec, xc) != 0;
      }
      const int boot = any_rec ? 0 : min(I.c, 1);
      const int left1 = place(k, a, s, V, mk_place(boot, EL_ALL, 0, I.restrict_all, I.za, RK_ALL, 0), i, oc, xc).left;
      const int rest = wsub(I.c, wsub(boot, left1));
      pending = place(k, a, s, V, mk_place(rest, EL_REC, 0, I.restrict_all, I.za, RK_NONE, 0), i, oc, xc).left;
    }
    if (tid == 0) a.leftovers[i] = pending;
    cp_async_wait_all();  // item i+1's data
    __syncthreads();
  }

  // the open slots back to the carry: the tile's state, every mask as planes
  const int oc_out = min(oc, N);
  for (int j = tid; j < oc_out; j += NT) {
    if (j < k.tile) {
      a.slot_basis[j] = k.sb[j];
      a.slot_rank[j] = k.sr[j];
      for (int r = 0; r < R; ++r) a.slot_rem[(size_t)j * R + r] = k.srem[(size_t)r * k.tile + j];
    }
    const uint32_t z = zs_at(k, j), pa = pa_at(k, j), pw = pw_at(k, j), ps = ps_at(k, j);
    for (int d = 0; d < D; ++d) a.slot_zoneset[(size_t)j * D + d] = (z >> d) & 1u;
    for (int p = 0; p < a.P1; ++p) {
      a.slot_pany[(size_t)j * a.P1 + p] = (pa >> p) & 1u;
      a.slot_pwild[(size_t)j * a.P1 + p] = (pw >> p) & 1u;
    }
    for (int p = 0; p < a.P2; ++p) a.slot_pspec[(size_t)j * a.P2 + p] = (ps >> p) & 1u;
  }
  if (tid == 0) a.open_count[0] = oc;
}

static void fill_args(PackArgs& a, const long long* ptrs, const int* dims) {
  const void** p = reinterpret_cast<const void**>(&a);
  const int n_ptrs = 38;
  for (int kk = 0; kk < n_ptrs; ++kk) p[kk] = reinterpret_cast<const void*>(ptrs[kk]);
  a.W = dims[0];
  a.N = dims[1];
  a.Nrows = dims[2];
  a.R = dims[3];
  a.D = dims[4];
  a.G = dims[5];
  a.Q = dims[6];
  a.Kd = dims[7];
  a.P1 = dims[8];
  a.P2 = dims[9];
  a.HB = dims[10];
  a.n_existing = dims[11];
  a.n_rows_real = dims[12];
}

// ptrs: the PackArgs pointers in declaration order; dims: W, N, Nrows, R, D,
// G, Q, Kd, P1, P2, HB, n_existing, n_rows_real
extern "C" int kt_pack_scan(const long long* ptrs, const int* dims, void* stream) {
  PackArgs a;
  fill_args(a, ptrs, dims);
  const Layout L = layout_of(a.N, a.Nrows, a.R, a.Q, a.D, a.n_existing);
  if (L.bytes + sizeof(Smem) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(pack_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (e != cudaSuccess) return (int)e;
  // block 0 scans; the item blocks (one item per warp up to MAX_ITEM_BLOCKS
  // blocks, all co-resident) build the item data first
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pack_scan_kernel, NT, L.bytes)) != cudaSuccess)
    return (int)e;
  int item_blocks = (a.W + NWARP - 1) / NWARP;
  item_blocks = min(max(item_blocks, 1), min(MAX_ITEM_BLOCKS, per_sm * sms - 1));
  if (item_blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)pack_scan_kernel, dim3(1 + item_blocks), dim3(NT), args, L.bytes,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// int32 words of scratch the kernel needs (same dims as kt_pack_scan)
extern "C" long long kt_pack_scan_scratch(const int* dims) {
  return (long long)scratch_of(dims[0], dims[1], dims[2], dims[6], dims[4], dims[11]).words;
}

extern "C" int kt_pack_scan_limits(int* out) {
  out[0] = MAX_R;
  out[1] = MAX_G;
  out[2] = MAX_Q;
  out[3] = MAX_D;
  out[4] = MAX_KD;
  return 0;
}
