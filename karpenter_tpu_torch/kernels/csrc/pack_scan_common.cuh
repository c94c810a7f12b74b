// The grouped pack scan's code shared by K2 (`pack_scan.cu`: one scan
// block) and its slot-sharded form (`pack_scan_sharded.cu`: one scan block
// per shard of the slot axis): the data layout, the slot and row accessors,
// `place`, the per-item prologue of the item blocks, the water-fills and
// the kernel's body, `pack_scan_body<NW, FITS, X>`. X is the scan policy:
// `BlockExchange` (below) keeps every slot in one block and compiles to K2
// as it was; a sharded policy gives each block the slots [base(), end()) of
// its shard and joins the shards' parts at the three slot-axis reductions
// (`X::gprefix`, `X::gsum`, `X::gany`). A policy also says how many words of
// dynamic shared memory it adds (`X::x_words`), what the scan blocks do
// before they read the item data (`X::wait_items`) and after the scan
// (`X::finish`). See `pack_scan.cu` for the design and
// `pack_scan_sharded.cu` for the sharded policies.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define NWARP (NT / 32)
#define TILE 1024
#define ROW_TILE 1024
#define INF_I (1 << 30)
#define BIGF 3.4e38f
#define FULL 0xffffffffu
#define SMEM_LIMIT 232448
#define MAX_ITEM_BLOCKS 64
#define T0_MASKS 12  // thread-0 scratch masks of the zone, anti and affinity branches

enum { K_DOM_SPREAD = 0, K_HOST_SPREAD = 1, K_HOST_ANTI = 2, K_DOM_ANTI = 3, K_DOM_AFF = 4, K_HOST_AFF = 5 };
// eligibility of a slot for one place() call
enum { EL_ALL = 0, EL_ZONE = 1, EL_ANTI = 2, EL_REC = 3 };
// which template ranks may open fresh slots in one place() call
enum { RK_ALL = 0, RK_BITS = 1, RK_NONE = 2 };
// the slots' bit-set planes (nw words each) and the rows' port planes
enum { ZS = 0, PA = 1, PW = 2, PS = 3 };
enum { RP_ANY = 0, RP_WILD = 1, RP_SPEC = 2 };
// an item record's scalars
enum { SC_C = 0, SC_PORTCAP, SC_HOSTCAP, SC_BRANCH, SC_NZMM, SC_NHOWN, SC_NHMEM, SC_NHAFF, SC_N };

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
  int* scratch;                    // see Scratch
  int W, N, Nrows, R, D, G, Q, Kd, P1, P2, HB, n_existing, n_rows_real;
  int nw;  // words of every bit set: ceil(max(D, Kd, P1, P2, Q) / 32), at least 1
};

__host__ __device__ inline int words_of(int n) { return n > 0 ? (n + 31) / 32 : 0; }

// what one item needs during its scan, built by one warp of the item blocks:
// offsets (4-byte words) into its record
struct RecLayout {
  int req, za, kmask, rs_all, rs_other, pany, pwild, pspec, ok_all, ok_other, openable, rank_fits, sc;
  int zmm, hown, hmem, haff, words;
};

__host__ __device__ inline RecLayout rec_of(int R, int Q, int G, int nw) {
  RecLayout L;
  int o = 0;
  L.req = o; o += R;
  L.za = o; o += nw;            // allowed domains
  L.kmask = o; o += nw;         // domains of the keyed member groups' key
  L.rs_all = o; o += nw;        // restricted keys
  L.rs_other = o; o += nw;      // restricted keys but the keyed one
  L.pany = o; o += nw;          // host ports
  L.pwild = o; o += nw;
  L.pspec = o; o += nw;
  L.ok_all = o; o += nw;        // bit q: the rank's domains pass the per-key restriction
  L.ok_other = o; o += nw;
  L.openable = o; o += nw;      // OR of rank_bits & rank_fits over fitting rows
  L.rank_fits = o; o += Q * nw; // per rank, bit d: a fresh slot in domain d holds one pod
  L.sc = o; o += SC_N;
  L.zmm = o; o += G;            // keyed-domain member groups, ascending
  L.hown = o; o += G;           // hostname gate groups the item owns
  L.hmem = o; o += G;           // hostname-counted groups the item is in
  L.haff = o; o += G;           // hostname-affinity groups the item owns
  L.words = (o + 3) & ~3;       // 16-byte records
  return L;
}

struct Smem {
  // block exchanges, two buffers each
  float xa_v[2][NWARP];
  int xa_i[2][NWARP];
  unsigned xmax[2][NWARP], xred[2][NWARP];
  // thread 0 -> all threads
  int pub_i[2];
};

// Per-block arena (4-byte words). The constants and thread-0 scratch, the
// exchange totals and the double-buffered item data are placed in dynamic
// shared memory where all three fit, else in the block's slice of the
// global spill, behind the same pointers (the scan then reads each item's
// data where the item blocks wrote it); then the row tile and the slot tile
// take what room is left (the first `rt` rows and `tile` slots; the rest
// stay in global memory). A policy's own region (`x_words`, the cluster
// exchange's parts) is always in shared memory, right after the item region.
struct Layout {
  int tile, rt, nch, nrw, nb, nw;
  bool fits;  // the constants, exchange totals and item buffers are in shared memory
  RecLayout rl;
  size_t consts_w, xtot_w, item_w;
  // offsets inside the consts region
  size_t keymask, rank_bits, reg_bits, gkind, gskew, rdcap, dcls, t0i, wv, wf, wf_ok, t0m, pubm, xblk;
  // offsets in shared memory (or in the spill) of each region
  size_t consts, xtot, item, xpart, rows, slots, spill_w, bytes;
};

__host__ __device__ inline Layout layout_of(int N, int Nrows, int R, int Q, int D, int G, int Kd, int nw,
                                            int n_existing, int n_loc, int static_extra, int x_words) {
  Layout L;
  L.nw = nw;
  L.nch = (n_loc + NT - 1) / NT;
  L.nrw = (Nrows + 31) / 32;
  L.nb = ((n_existing < N ? n_existing : N) + 31) / 32;
  L.rl = rec_of(R, Q, G, nw);
  size_t o = 0;
  L.keymask = o; o += (size_t)Kd * nw;
  L.rank_bits = o; o += (size_t)Q * nw;
  L.reg_bits = o; o += (size_t)G * nw;
  L.gkind = o; o += G;
  L.gskew = o; o += G;
  L.rdcap = o; o += (size_t)Q * D * R;
  L.dcls = o; o += (size_t)Q * D * nw;  // [Q, D] masks: the domains whose rank caps equal d's, bit for bit
  L.t0i = o; o += 7 * (size_t)D;        // inc, placed_z, vsum, capd, wcap, lvl, react
  L.wv = o; o += D;
  L.wf = o; o += 3 * (size_t)G;         // wf_a, wf_b, wf_c
  L.wf_ok = o; o += (size_t)G * nw;
  L.t0m = o; o += (size_t)T0_MASKS * nw;
  L.pubm = o; o += 4 * (size_t)nw;      // two buffers of two published masks
  L.xblk = o; o += 2 * (size_t)NWARP * nw;  // two buffers of per-warp OR words
  L.consts_w = (o + 3) & ~(size_t)3;
  L.xtot_w = (2 * (size_t)L.nch * NWARP + 3) & ~(size_t)3;
  L.item_w = 2 * ((size_t)L.rl.words + (((size_t)Q * D + 3) & ~(size_t)3) + (((size_t)L.nrw + 3) & ~(size_t)3) +
                  (((size_t)L.nb + 3) & ~(size_t)3));
  // the constants, exchange totals and item data first (all three or none),
  // then the two tiles
  long long room = ((long long)SMEM_LIMIT - (long long)sizeof(Smem) - static_extra) / 4 - x_words;
  L.fits = (long long)(L.consts_w + L.xtot_w + L.item_w) <= room;
  if (L.fits) room -= L.consts_w + L.xtot_w + L.item_w;
  const long long per_row = 1 + 3LL * nw + (L.fits ? 4 : 0);  // rank, port masks, rowinfo and rowkey x 2
  long long rt = room / per_row;
  rt = rt < Nrows ? rt : Nrows;
  L.rt = (int)(rt < ROW_TILE ? rt : ROW_TILE);
  room -= (long long)L.rt * per_row;
  const long long per_slot = 5 + 4LL * nw + R;  // basis, rank, take, take item, take value, 4 masks, rem
  long long tile = room > 0 ? room / per_slot : 0;
  tile = tile < n_loc ? tile : n_loc;
  L.tile = (int)(tile < TILE ? tile : TILE);
  // addresses: the item region first (16-byte aligned records)
  size_t s = 0, g = 0;
  size_t& o2 = L.fits ? s : g;  // where the constants and exchange totals go
  L.item = s; s += L.fits ? L.item_w : 0;
  L.xpart = s; s += x_words;
  L.consts = o2; o2 += L.consts_w;
  L.xtot = o2; o2 += L.xtot_w;
  L.rows = s; s += (size_t)L.rt * per_row;
  L.slots = s; s += (size_t)L.tile * per_slot;
  L.bytes = s * 4;
  L.spill_w = g;
  return L;
}

// global scratch (4-byte words, zero-filled by the caller): the count of
// finished item blocks, the masks and takes of the slots past the tile, then
// per item its record, open caps, rows (fits | cap), compat bits over the
// rows and host-blocked bits over the existing slots; then each block's
// spill (the arena regions that shared memory does not hold)
struct Scratch {
  size_t done, xbar, far, recs, opencap, rowinfo, cbits, hbw, spill, xparts, words;
};

// words of one shard's part of an exchange: two totals, or nw mask words
__host__ __device__ inline int xw_of(int nw) { return ((nw > 2 ? nw : 2) + 3) & ~3; }

__host__ __device__ inline Scratch scratch_of(const Layout& L, int W, int N, int Nrows, int Q, int D, int n_scan) {
  Scratch S;
  size_t o = 0;
  S.done = o;
  S.xbar = o + 1;  // the shard blocks' barrier counter (one shard block: unused)
  o += 4;
  S.far = o; o += (4 * (size_t)L.nw + 1) * N;
  o = (o + 3) & ~(size_t)3;
  S.recs = o; o += (size_t)W * L.rl.words;
  S.opencap = o; o += (size_t)W * Q * D;
  S.rowinfo = o; o += (size_t)W * Nrows;
  S.cbits = o; o += (size_t)W * L.nrw;
  S.hbw = o; o += (size_t)W * L.nb;
  o = (o + 3) & ~(size_t)3;
  S.spill = o; o += (size_t)(n_scan + MAX_ITEM_BLOCKS) * L.spill_w;
  S.xparts = o; o += n_scan > 1 ? 2 * (size_t)n_scan * xw_of(L.nw) : 0;  // two buffers of the shards' parts
  S.words = o;
  return S;
}

// the block's view of the slot state (shared for j < tile, global past it),
// of the rows, the constants and the item data. NW > 0 fixes the words of
// every bit set at compile time (the common case: one); NW == 0 reads it.
// FITS: the constants, exchange totals and item buffers are in shared
// memory (their loads are then shared-memory loads). SH: the block is one
// shard of a slot-sharded scan and owns slots [base(), end()); the tile
// then holds the first `tile` of them.
template <int NW, bool FITS, bool SH = false>
struct Ctx {
  static constexpr bool kFits = FITS;
  static constexpr bool kSharded = SH;
  int nw_rt, tile, rt, nch, nrw, nb, N;
  int lo, hi, shard, nshard, xw;  // SH only
  unsigned* xbar;                 // SH only: the shard blocks' exchange counter
  uint32_t* xparts;               // SH only: the parts (global scratch or the block's shared memory; see the policy)
  int* cz;                        // counts_zone (the shard's own copy when SH)
  __device__ __forceinline__ int nw() const { return NW > 0 ? NW : nw_rt; }
  __device__ __forceinline__ int base() const { return SH ? lo : 0; }
  __device__ __forceinline__ int end() const { return SH ? hi : N; }
  // the end of the shard's part of the open range [0, oc)
  __device__ __forceinline__ int act(int oc) const { return SH ? min(oc, hi) : oc; }
  int *sb, *sr, *stk, *stki, *stkv;
  uint32_t* smask;  // [4][nw][tile]: domain set, port any / wild / spec
  float* srem;      // [R][tile]
  uint32_t* gmask;  // [4][nw][N]
  int* gtk;
  int* rowrank;     // row_pool_rank of the row tile
  uint32_t* rmask;  // [3][nw][rt]: port masks of the row tile
  uint32_t *keymask, *rank_bits, *reg_bits, *dcls;
  int *gkind, *gskew;
  float* rdcap;
  // thread-0 scratch of the zone, anti and affinity branches
  int *inc, *placed_z, *vsum, *capd, *wcap, *lvl, *react;
  float* wv;
  int *wf_a, *wf_b, *wf_c;
  uint32_t *wf_ok, *t0m;
  uint32_t *pubm, *xblk;
  // two buffers of item data in shared memory (null when it lives in global memory only)
  uint32_t* irec;
  int *iopen, *irowinfo;
  float* irowkey;
  uint32_t *icbits, *ihbw;
  unsigned* xtot;
  RecLayout rl;
  uint32_t* g_recs;
  int *g_opencap, *g_rowinfo;
  uint32_t *g_cbits, *g_hbw;
  __device__ __forceinline__ uint32_t* t0mask(int m) const { return t0m + (size_t)m * nw(); }
  __device__ __forceinline__ uint32_t* pub(int b, int m) const { return pubm + (size_t)(2 * b + m) * nw(); }
};

struct Item {
  const float* req;
  const uint32_t *za, *kmask, *rs_all, *rs_other, *pany, *pwild, *pspec, *ok_all, *ok_other, *openable, *rank_fits;
  const int *zmm, *hown, *hmem, *haff;
  int c, port_cap, host_cap_new, branch, n_zmm, n_hown, n_hmem, n_haff;
};

__device__ __forceinline__ Item item_of(const RecLayout& L, const uint32_t* b) {
  Item I;
  I.req = reinterpret_cast<const float*>(b + L.req);
  I.za = b + L.za;
  I.kmask = b + L.kmask;
  I.rs_all = b + L.rs_all;
  I.rs_other = b + L.rs_other;
  I.pany = b + L.pany;
  I.pwild = b + L.pwild;
  I.pspec = b + L.pspec;
  I.ok_all = b + L.ok_all;
  I.ok_other = b + L.ok_other;
  I.openable = b + L.openable;
  I.rank_fits = b + L.rank_fits;
  I.zmm = reinterpret_cast<const int*>(b + L.zmm);
  I.hown = reinterpret_cast<const int*>(b + L.hown);
  I.hmem = reinterpret_cast<const int*>(b + L.hmem);
  I.haff = reinterpret_cast<const int*>(b + L.haff);
  const int* sc = reinterpret_cast<const int*>(b + L.sc);
  I.c = sc[SC_C];
  I.port_cap = sc[SC_PORTCAP];
  I.host_cap_new = sc[SC_HOSTCAP];
  I.branch = sc[SC_BRANCH];
  I.n_zmm = sc[SC_NZMM];
  I.n_hown = sc[SC_NHOWN];
  I.n_hmem = sc[SC_NHMEM];
  I.n_haff = sc[SC_NHAFF];
  return I;
}

// the current item's data (in shared memory, or where the item blocks wrote
// it; its rows past the row tile always in global memory)
struct ItemView {
  Item I;
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
  const uint32_t* selp;  // the slots' and ranks' selector: a mask, or (null) the one domain selz
  int selz;
  const uint32_t* narp;  // the narrowing of the domain sets: a mask, or (null) narrow_of(I, narz)
  int narz;
  const uint32_t* restrict_mask;
  bool want_blocked;
};

struct Placed {
  int left;
  int blk;  // the exchange buffer holding the OR of the touched slots' narrowed sets, or -1
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
// word w of the set [0, n)
__device__ __forceinline__ uint32_t full_word(int n, int w) {
  const int k = n - 32 * w;
  return k >= 32 ? FULL : (k <= 0 ? 0u : ((1u << k) - 1u));
}
__device__ __forceinline__ bool bt(const uint32_t* m, int d) { return (m[d >> 5] >> (d & 31)) & 1u; }
__device__ __forceinline__ void bset(uint32_t* m, int d) { m[d >> 5] |= 1u << (d & 31); }
__device__ __forceinline__ void bclr(uint32_t* m, int d) { m[d >> 5] &= ~(1u << (d & 31)); }
__device__ __forceinline__ int popc_m(const uint32_t* m, int nw) {
  int n = 0;
  for (int w = 0; w < nw; ++w) n += __popc(m[w]);
  return n;
}
__device__ __forceinline__ bool any_m(const uint32_t* m, int nw) {
  for (int w = 0; w < nw; ++w)
    if (m[w]) return true;
  return false;
}
// word w (bits [32 w, 32 w + 32)) of row `row` of a [*, n] bool plane
__device__ __forceinline__ uint32_t plane_word(const uint8_t* plane, size_t row, int n, int w) {
  uint32_t m = 0;
  const int lo = 32 * w, hi = min(n, lo + 32);
  for (int x = lo; x < hi; ++x) m |= (uint32_t)(plane[row * n + x] != 0) << (x - lo);
  return m;
}

__device__ __forceinline__ uint32_t sel_w(const Place& P, int w) {
  return P.selp ? P.selp[w] : (w == (P.selz >> 5) ? 1u << (P.selz & 31) : 0u);
}
__device__ __forceinline__ uint32_t nar_w(const Place& P, const Item& I, int w) {
  if (P.narp) return P.narp[w];
  return ((w == (P.narz >> 5)) ? I.kmask[w] & (1u << (P.narz & 31)) : 0u) | (I.za[w] & ~I.kmask[w]);
}

template <class C>
__device__ __forceinline__ int row_rank(const C& k, const PackArgs& a, int r) {
  return r < k.rt ? k.rowrank[r] : a.row_pool_rank[r];
}
template <class C>
__device__ __forceinline__ int rowq_of(const C& k, const PackArgs& a, int r) { return clampi(row_rank(k, a, r), 0, a.Q - 1); }
template <class C>
__device__ __forceinline__ int row_info(const C& k, const ItemView& V, int r) { return r < k.rt ? V.rowinfo[r] : V.g_rowinfo[r]; }
template <class C>
__device__ __forceinline__ float row_key(const C& k, const ItemView& V, int r) { return r < k.rt ? V.rowkey[r] : V.g_rowkey[r]; }

// word w of a row's host-port plane p
template <class C>
__device__ __forceinline__ uint32_t row_port_word(const C& k, const PackArgs& a, int r, int p, int w) {
  if (r < k.rt) return k.rmask[((size_t)p * k.nw() + w) * k.rt + r];
  return p == RP_SPEC ? plane_word(a.row_port_spec, r, a.P2, w)
                      : plane_word(p == RP_ANY ? a.row_port_any : a.row_port_wild, r, a.P1, w);
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

template <class C>
__device__ __forceinline__ int& basis_at(const C& k, const PackArgs& a, int j) {
  const int jl = j - k.base();
  return jl < k.tile ? k.sb[jl] : a.slot_basis[j];
}
template <class C>
__device__ __forceinline__ int& rank_at(const C& k, const PackArgs& a, int j) {
  const int jl = j - k.base();
  return jl < k.tile ? k.sr[jl] : a.slot_rank[j];
}
template <class C>
__device__ __forceinline__ int& tk_at(const C& k, int j) {
  const int jl = j - k.base();
  return jl < k.tile ? k.stk[jl] : k.gtk[j];
}
// word w of slot j's plane p (ZS, PA, PW, PS)
template <class C>
__device__ __forceinline__ uint32_t& sm_at(const C& k, int p, int j, int w) {
  const int jl = j - k.base();
  return jl < k.tile ? k.smask[((size_t)p * k.nw() + w) * k.tile + jl] : k.gmask[((size_t)p * k.nw() + w) * k.N + j];
}
template <class C>
__device__ __forceinline__ float& rem_at(const C& k, const PackArgs& a, int j, int r) {
  const int jl = j - k.base();
  return jl < k.tile ? k.srem[(size_t)r * k.tile + jl] : a.slot_rem[(size_t)j * a.R + r];
}

// takes[i, j] += take. A tile slot keeps the item's running take in shared
// memory, so the global take matrix is only written.
template <class C>
__device__ __forceinline__ void add_take(const C& k, const PackArgs& a, int i, int j, int take) {
  int* tp = a.takes + (size_t)i * a.N + j;
  const int jl = j - k.base();
  if (jl < k.tile) {
    const int v = k.stki[jl] == i ? wadd(k.stkv[jl], take) : take;
    k.stki[jl] = i;
    k.stkv[jl] = v;
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

template <class C>
__device__ __forceinline__ int int_cap_slot(const C& k, const PackArgs& a, int j, const float* req) {
  float cap = BIGF;
#pragma unroll 4
  for (int r = 0; r < a.R; ++r) cap = fminf(cap, cap_term(rem_at(k, a, j, r), req[r]));
  return cap_int(cap);
}

// every restricted key keeps an allowed domain in the set (set(w): its word w)
template <class C, class SetW>
__device__ __forceinline__ bool perkey_ok(const C& k, const uint32_t* za, const SetW& set, const uint32_t* rs) {
  const int nw = k.nw();
  for (int w0 = 0; w0 < nw; ++w0) {
    for (uint32_t m = rs[w0]; m; m &= m - 1) {
      const uint32_t* km = k.keymask + (size_t)(w0 * 32 + __ffs(m) - 1) * nw;
      bool hit = false;
      for (int w = 0; w < nw && !hit; ++w) hit = (set(w) & za[w] & km[w]) != 0;
      if (!hit) return false;
    }
  }
  return true;
}

template <class C>
__device__ __forceinline__ bool slot_compat(const C& k, const PackArgs& a, const ItemView& V, int j) {
  const int b = basis_at(k, a, j);
  if (b < 0) return false;
  const int cb = clampi(b, 0, a.Nrows - 1);
  if (!((V.cbits[cb >> 5] >> (cb & 31)) & 1u)) return false;
  return !(j < a.n_existing && ((V.hbw[j >> 5] >> (j & 31)) & 1u));
}

template <class C>
__device__ __forceinline__ bool port_ok(const C& k, const Item& I, int j) {
  for (int w = 0; w < k.nw(); ++w)
    if ((sm_at(k, PA, j, w) & I.pwild[w]) | (sm_at(k, PW, j, w) & I.pany[w]) | (sm_at(k, PS, j, w) & I.pspec[w]))
      return false;
  return true;
}

__device__ __forceinline__ bool rec_ok(const PackArgs& a, const Item& I, int j) {
  for (int t = 0; t < I.n_haff; ++t)
    if (a.counts_host[(size_t)I.haff[t] * a.N + j] <= 0) return false;
  return true;
}

// per-slot capacity of one place() call (0 where ineligible)
template <class C>
__device__ __forceinline__ int slot_cap(const C& k, const PackArgs& a, const ItemView& V, const Place& P, int j) {
  const Item& I = V.I;
  const int nw = k.nw();
  if (!slot_compat(k, a, V, j)) return 0;
  if (!perkey_ok(k, I.za, [&](int w) { return sm_at(k, ZS, j, w); }, P.restrict_mask)) return 0;
  if (P.el == EL_ZONE || P.el == EL_ANTI) {
    bool hit = false;
    for (int w = 0; w < nw && !hit; ++w) hit = (sm_at(k, ZS, j, w) & sel_w(P, w)) != 0;
    if (!hit) return 0;
  }
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
    int v = k.gkind[g] == K_HOST_SPREAD ? wsub(k.gskew[g], ch) : (ch == 0 ? 1 : 0);
    mhc = min(mhc, v);
  }
  if (mhc <= 0) return 0;
  int rank = rank_at(k, a, j);
  int cap_dom;
  if (rank < 0) {
    cap_dom = INF_I;
  } else {
    const float* alloc = a.row_alloc + (size_t)clampi(basis_at(k, a, j), 0, a.Nrows - 1) * R;
    const int q = clampi(rank, 0, a.Q - 1);
    const float* rdc = k.rdcap + (size_t)q * a.D * R;
    // the max over the target domains of the capacity left under each
    // domain's cap: domains of this rank with equal caps give equal terms,
    // so one of each class (per word of the set) is evaluated
    const uint32_t* cls = k.dcls + (size_t)q * a.D * nw;
    cap_dom = 0;
    for (int w = 0; w < nw; ++w) {
      uint32_t target = sm_at(k, ZS, j, w) & nar_w(P, I, w);
      while (target) {
        const int d = w * 32 + __ffs(target) - 1;
        target &= ~cls[(size_t)d * nw + w];
        float cap = BIGF;
#pragma unroll 4
        for (int r = 0; r < R; ++r) {
          float total = __fsub_rn(alloc[r], rem_at(k, a, j, r));
          cap = fminf(cap, cap_term(__fsub_rn(rdc[d * R + r], total), I.req[r]));
        }
        cap_dom = max(cap_dom, cap_int(cap));
      }
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

template <class C>
__device__ __forceinline__ bool rank_ok(const C& k, const Item& I, const Place& P, int q) {
  if (P.rk == RK_ALL) return bt(I.ok_all, q);
  if (P.rk == RK_NONE || !bt(I.ok_other, q)) return false;
  const uint32_t* rb = k.rank_bits + (size_t)q * k.nw();
  for (int w = 0; w < k.nw(); ++w)
    if (rb[w] & sel_w(P, w)) return true;
  return false;
}

// a fresh slot of rank q could open in a narrowed domain where it holds a pod
template <class C>
__device__ __forceinline__ bool rank_opens(const C& k, const Item& I, const Place& P, int q) {
  const int nw = k.nw();
  const uint32_t* rb = k.rank_bits + (size_t)q * nw;
  const uint32_t* rf = I.rank_fits + (size_t)q * nw;
  for (int w = 0; w < nw; ++w)
    if (rb[w] & nar_w(P, I, w) & rf[w]) return true;
  return false;
}

// The slot-axis OR (gany_slots) of nw-word sets, one exchange: each warp
// ORs into its own words of buffer b (zeroed by its lane 0 first), one
// barrier, then any thread reads the OR over the warps. A buffer is
// written again only two exchanges later, after a barrier that every
// reader of this one has passed.
template <class C>
__device__ __forceinline__ uint32_t* gany_buf(const C& k, int b, int warp) {
  return k.xblk + (size_t)(b * NWARP + warp) * k.nw();
}
template <class C>
__device__ __forceinline__ void gany_zero(const C& k, int b) {
  if ((threadIdx.x & 31) == 0)
    for (int w = 0; w < k.nw(); ++w) gany_buf(k, b, threadIdx.x >> 5)[w] = 0;
  __syncwarp();
}
template <class C>
__device__ __forceinline__ void gany_or(const C& k, int b, int w, uint32_t v) {
  if (v) atomicOr(gany_buf(k, b, threadIdx.x >> 5) + w, v);
}
template <class C>
__device__ __forceinline__ uint32_t gany_word(const C& k, int b, int w) {
  uint32_t out = 0;
  for (int ww = 0; ww < NWARP; ++ww) out |= gany_buf(k, b, ww)[w];
  return out;
}

// Place P.cnt identical pods: prefix-sum first-fit over the eligible open
// slots, then fresh slots of the best row for the leftover. `oc` is the
// running open count and `xc` the exchange count (both the same in every
// thread). Returns the leftover and, where asked, the exchange buffer of the
// OR of the touched slots' narrowed domain sets. In a shard block (X a
// sharded policy) the slot loops cover the shard's slots and the three
// slot-axis reductions also go through X's exchange with the other shards.
template <class X, class C>
__device__ __forceinline__ Placed place(const C& k, const PackArgs& a, Smem& s, const ItemView& V, const Place& P,
                                        int i, int& oc, int& xc) {
  const Item& I = V.I;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int R = a.R, Nr = a.Nrows, nw = k.nw();
  const int oc0 = oc, ahi = k.act(oc0);  // this block's open slots: [base, ahi)
  const int nch = C::kSharded ? (max(ahi - k.base(), 0) + NT - 1) / NT : (oc0 + NT - 1) / NT;

  // -- gprefix, first half: capacities and warp scans of the open slots; the
  //    row argmin and the largest capacity ride on the same exchange
  const int b1 = xc & 1;
  unsigned* tot = k.xtot + (size_t)b1 * k.nch * NWARP;
  unsigned mx = 0, cap0 = 0, excl0 = 0;  // chunk 0's capacity and warp prefix stay in registers
  for (int c = 0; c < nch; ++c) {
    const int j = k.base() + c * NT + tid;
    const int cap = j < ahi ? slot_cap(k, a, V, P, j) : 0;
    if (j < ahi) tk_at(k, j) = cap;
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
    const bool fr = row_info(k, V, r) < 0 && rank_ok(k, I, P, q) && rank_opens(k, I, P, q);
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
  unsigned run = 0, local = 0, total = 0;
  // a shard: the earlier shards' capacity total starts its prefix; the
  // total and the largest capacity become the whole axis'
  if constexpr (C::kSharded) X::gprefix(k, tot, nch, run, total, mxall);
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
    const int j = k.base() + c * NT + tid;
    const unsigned cap = c == 0 ? cap0 : (j < ahi ? (unsigned)tk_at(k, j) : 0u);
    const unsigned excl = c == 0 ? excl0 : warp_incl_scan(cap, lane) - cap;
    const unsigned pre = run + pre_w + excl;
    if (j < ahi) {
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
    sum = (unsigned)min(P.cnt, (int)(C::kSharded ? total : run));
  } else {
    local = __reduce_add_sync(FULL, local);
    const int b2 = xc & 1;
    if (lane == 0) s.xred[b2][w] = local;
    __syncthreads();
    ++xc;
    sum = 0;
    for (int ww = 0; ww < NWARP; ++ww) sum += s.xred[b2][ww];
    if constexpr (C::kSharded) sum = X::gsum(k, sum);
  }
  const int left = wsub(P.cnt, (int)sum);

  // -- the best row and how many fresh slots of it (every thread, same values)
  const int q = rowq_of(k, a, o);
  const int ro = row_info(k, V, o);
  const bool o_ok = ro < 0 && rank_ok(k, I, P, q) && rank_opens(k, I, P, q);
  int cap_open = 0;
  const uint32_t* rbq = k.rank_bits + (size_t)q * nw;
  for (int ww = 0; ww < nw; ++ww)
    for (uint32_t sel = rbq[ww] & nar_w(P, I, ww); sel; sel &= sel - 1)
      cap_open = max(cap_open, V.opencap[q * a.D + ww * 32 + __ffs(sel) - 1]);
  const int cstar = min(min(min(ro & 0x7fffffff, cap_open), I.host_cap_new), I.port_cap);
  const bool can_open = o_ok && cstar >= 1;
  int m = can_open ? wsub(0, floordiv(wsub(0, left), max(cstar, 1))) : 0;
  m = min(max(m, 0), a.N - oc0);

  // -- update: the takes of the open slots, then the fresh slots
  const int hi = oc0 + m;
  const int o_rank = row_rank(k, a, o);
  const int bb = xc & 1;
  if (P.want_blocked) gany_zero(k, bb);
  const int uhi = k.act(hi);  // this block's slots of [0, hi)
  for (int base = k.base(); base < uhi; base += NT) {
    const int j = base + tid;
    if (j >= uhi) continue;
    int take = j < oc0 ? tk_at(k, j) : 0;
    if (j >= oc0) {
      const int x = wsub(left, wmul(j - oc0, cstar));
      take += min(max(x, 0), cstar);
      basis_at(k, a, j) = o;
      rank_at(k, a, j) = o_rank;
      for (int r = 0; r < R; ++r) rem_at(k, a, j, r) = a.row_alloc[(size_t)o * R + r];
      for (int ww = 0; ww < nw; ++ww) {
        sm_at(k, ZS, j, ww) = rbq[ww] & nar_w(P, I, ww);
        sm_at(k, PA, j, ww) = row_port_word(k, a, o, RP_ANY, ww);
        sm_at(k, PW, j, ww) = row_port_word(k, a, o, RP_WILD, ww);
        sm_at(k, PS, j, ww) = row_port_word(k, a, o, RP_SPEC, ww);
      }
    }
    if (take > 0) {
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
      for (int ww = 0; ww < nw; ++ww) {
        const uint32_t z = sm_at(k, ZS, j, ww) & nar_w(P, I, ww);
        sm_at(k, ZS, j, ww) = z;
        sm_at(k, PA, j, ww) |= I.pany[ww];
        sm_at(k, PW, j, ww) |= I.pwild[ww];
        sm_at(k, PS, j, ww) |= I.pspec[ww];
        if (P.want_blocked) gany_or(k, bb, ww, z);
      }
      add_take(k, a, i, j, take);
    }
  }
  // the fresh slots take min(left, m * cstar) in all: each takes cstar but
  // the last, and (m - 1) * cstar < left keeps every term exact
  const int new_sum = m > 0 ? (int)min((long long)left, (long long)m * cstar) : 0;
  oc = wadd(oc0, m);
  Placed res;
  res.left = wsub(left, new_sum);
  res.blk = -1;
  if (P.want_blocked) {
    __syncthreads();
    ++xc;
    if constexpr (C::kSharded) X::gany(k, bb);
    res.blk = bb;
  }
  return res;
}

// -- per-item prologue (one warp of the item blocks) ---------------------------

template <class C>
__device__ __forceinline__ void item_prologue(const C& k, const PackArgs& a, int i, uint32_t* rec, int* opencap) {
  const int lane = threadIdx.x & 31;
  const int D = a.D, G = a.G, Q = a.Q, R = a.R, Kd = a.Kd, nw = k.nw();
  const RecLayout& L = k.rl;
  const uint32_t lt = (1u << lane) - 1u;
  float* req = reinterpret_cast<float*>(rec + L.req);
  int* sc = reinterpret_cast<int*>(rec + L.sc);
  __syncwarp();
  for (int r = lane; r < R; r += 32) req[r] = a.item_req[(size_t)i * R + r];
  // the item's bit sets, one ballot per word
  uint32_t pa_any = 0;
  for (int w = 0; w < nw; ++w) {
    const int x = 32 * w + lane;
    const uint32_t za = __ballot_sync(FULL, x < D && a.item_dom_allowed[(size_t)i * D + x] != 0);
    const uint32_t rs = __ballot_sync(FULL, x < Kd && a.item_restrict[(size_t)i * Kd + x] != 0);
    const uint32_t pa = __ballot_sync(FULL, x < a.P1 && a.item_port_any[(size_t)i * a.P1 + x] != 0);
    const uint32_t pw = __ballot_sync(FULL, x < a.P1 && a.item_port_wild[(size_t)i * a.P1 + x] != 0);
    const uint32_t ps = __ballot_sync(FULL, x < a.P2 && a.item_port_spec[(size_t)i * a.P2 + x] != 0);
    if (lane == 0) {
      rec[L.za + w] = za;
      rec[L.rs_all + w] = rs;
      rec[L.pany + w] = pa;
      rec[L.pwild + w] = pw;
      rec[L.pspec + w] = ps;
    }
    pa_any |= pa;
  }
  int n_zmm = 0, n_hown = 0, n_hmem = 0, n_haff = 0, kstar = -1, hcap = INF_I;
  bool anti = false, domaff = false, hostaff = false;
  int* zmm = reinterpret_cast<int*>(rec + L.zmm);
  int* hown = reinterpret_cast<int*>(rec + L.hown);
  int* hmem = reinterpret_cast<int*>(rec + L.hmem);
  int* haff = reinterpret_cast<int*>(rec + L.haff);
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
    if (zm) zmm[n_zmm + __popc(b & lt)] = g;
    n_zmm += __popc(b);
    b = __ballot_sync(FULL, ho);
    if (ho) hown[n_hown + __popc(b & lt)] = g;
    n_hown += __popc(b);
    b = __ballot_sync(FULL, hm);
    if (hm) hmem[n_hmem + __popc(b & lt)] = g;
    n_hmem += __popc(b);
    b = __ballot_sync(FULL, ha);
    if (ha) haff[n_haff + __popc(b & lt)] = g;
    n_haff += __popc(b);
    kstar = max(kstar, __reduce_max_sync(FULL, zm ? a.group_dom_key[g] : -1));
    hcap = min(hcap, __reduce_min_sync(FULL, ho ? (kind == K_HOST_SPREAD ? a.group_skew[g] : 1) : INF_I));
    anti |= __any_sync(FULL, zm && kind == K_DOM_ANTI);
    domaff |= __any_sync(FULL, zm && kind == K_DOM_AFF);
    hostaff |= __any_sync(FULL, mem && kind == K_HOST_AFF);
  }
  for (int w = 0; w < nw; ++w) {
    const int x = 32 * w + lane;
    const uint32_t km = __ballot_sync(FULL, x < D && a.dom_key_of[x] == kstar);
    if (lane == 0) {
      rec[L.kmask + w] = km;
      rec[L.rs_other + w] = rec[L.rs_all + w] & ((kstar >= 0 && (kstar >> 5) == w) ? ~(1u << (kstar & 31)) : FULL);
    }
  }
  __syncwarp();  // za, the restrictions, req
  const uint32_t* za = rec + L.za;
  for (int q0 = 0; q0 < Q; q0 += 32) {
    const int q = q0 + lane;
    const uint32_t* rb = k.rank_bits + (size_t)min(q, Q - 1) * nw;
    auto set = [&](int w) { return rb[w]; };
    const uint32_t ok_all = __ballot_sync(FULL, q < Q && perkey_ok(k, za, set, rec + L.rs_all));
    const uint32_t ok_other = __ballot_sync(FULL, q < Q && perkey_ok(k, za, set, rec + L.rs_other));
    if (lane == 0) {
      rec[L.ok_all + (q0 >> 5)] = ok_all;
      rec[L.ok_other + (q0 >> 5)] = ok_other;
    }
  }
  for (int e = lane; e < Q * D; e += 32) opencap[e] = int_cap(k.rdcap + (size_t)e * R, req, R);
  __syncwarp();  // open caps
  for (int e = lane; e < Q * nw; e += 32) {
    const int q = e / nw, w = e - q * nw;
    uint32_t f = 0;
    for (int d = 32 * w; d < min(D, 32 * w + 32); ++d) f |= (uint32_t)(opencap[q * D + d] >= 1) << (d - 32 * w);
    rec[L.rank_fits + e] = f;
  }
  // rows: fits (sign bit) and capacity of a fresh slot, the compat bits;
  // host-blocked bits of the existing slots
  const int Nr = a.Nrows;
  int* rowinfo = k.g_rowinfo + (size_t)i * Nr;
  for (int r0 = 0; r0 < Nr; r0 += 32) {
    const int r = r0 + lane;
    const bool in = r < Nr;
    const bool c = in && a.compat[(size_t)i * Nr + r] != 0;
    const uint32_t cb = __ballot_sync(FULL, c);
    if (lane == 0) k.g_cbits[(size_t)i * k.nrw + (r0 >> 5)] = cb;
    if (in) {
      bool fits = c && r >= a.n_existing && r < a.n_rows_real;
#pragma unroll 4
      for (int kk = 0; kk < R; ++kk) fits = fits && req[kk] <= a.row_alloc[(size_t)r * R + kk];
      for (int w = 0; w < nw && fits; ++w)
        fits = ((row_port_word(k, a, r, RP_ANY, w) & rec[L.pwild + w]) |
                (row_port_word(k, a, r, RP_WILD, w) & rec[L.pany + w]) |
                (row_port_word(k, a, r, RP_SPEC, w) & rec[L.pspec + w])) == 0;
      rowinfo[r] = int_cap(a.row_alloc + (size_t)r * R, req, R) | (fits ? (int)0x80000000 : 0);
    }
  }
  const int n_blk = min(a.n_existing, a.N);
  for (int j0 = 0; j0 < n_blk; j0 += 32) {
    const int j = j0 + lane;
    const bool b = j < n_blk && a.item_host_blocked[(size_t)i * a.HB + clampi(j, 0, a.HB - 1)] != 0;
    const uint32_t hb = __ballot_sync(FULL, b);
    if (lane == 0) k.g_hbw[(size_t)i * k.nb + (j0 >> 5)] = hb;
  }
  __syncwarp();  // rank_fits, ok_other, rowinfo
  // the domains a fresh slot could open in: rank_bits & rank_fits of the
  // ranks of fitting rows that pass the other keys' restriction
  for (int w = 0; w < nw; ++w) {
    uint32_t openable = 0;
    for (int r = lane; r < Nr; r += 32) {
      const int q = rowq_of(k, a, r);
      if (rowinfo[r] < 0 && bt(rec + L.ok_other, q))
        openable |= k.rank_bits[(size_t)q * nw + w] & rec[L.rank_fits + (size_t)q * nw + w];
    }
    openable = __reduce_or_sync(FULL, openable);
    if (lane == 0) rec[L.openable + w] = openable;
  }
  if (lane == 0) {
    sc[SC_C] = a.item_count[i];
    sc[SC_PORTCAP] = pa_any ? 1 : INF_I;
    sc[SC_HOSTCAP] = hcap;
    sc[SC_BRANCH] = hostaff ? 4 : domaff ? 3 : anti ? 2 : (n_zmm > 0 ? 1 : 0);
    sc[SC_NZMM] = n_zmm;
    sc[SC_NHOWN] = n_hown;
    sc[SC_NHMEM] = n_hmem;
    sc[SC_NHAFF] = n_haff;
  }
}

// -- thread-0 helpers of the zone branch ---------------------------------------

// the domains every keyed member group's spread admits, into `ok`
template <class C>
__device__ __forceinline__ void spread_ok_bits(const C& k, const PackArgs& a, const Item& I, uint32_t* ok) {
  const int D = a.D, nw = k.nw();
  for (int w = 0; w < nw; ++w) ok[w] = full_word(D, w);
  for (int t = 0; t < I.n_zmm; ++t) {
    int g = I.zmm[t];
    const uint32_t* reg = k.reg_bits + (size_t)g * nw;
    const int* cz = k.cz + (size_t)g * D;
    int zmin = INF_I, nzr = 0;
    for (int d = 0; d < D; ++d)
      if (bt(I.za, d) && bt(reg, d)) {
        zmin = min(zmin, cz[d]);
        ++nzr;
      }
    if (zmin >= INF_I) zmin = 0;
    int md = a.group_min_domains[g];
    if (md > 0 && nzr < md) zmin = 0;
    bool anti = a.group_kind[g] == K_DOM_ANTI;
    for (int d = 0; d < D; ++d) {
      bool pg = anti ? cz[d] == 0 : wsub(wadd(cz[d], 1), zmin) <= a.group_skew[g];
      if (!(pg && bt(reg, d))) bclr(ok, d);
    }
  }
}

// integer water-fill (2Z+2 rounds, then the remainder to the lowest-index
// minimum entries); v/cap over D entries, result into k.inc
template <class C>
__device__ __forceinline__ void waterfill(const C& k, const PackArgs& a, const int* v, const uint32_t* finite, int c,
                                          const int* cap) {
  const int D = a.D;
  float* vf = k.wv;
  int* capf = k.wcap;
  int* inc = k.inc;
  for (int d = 0; d < D; ++d) {
    vf[d] = bt(finite, d) ? (float)v[d] : BIGF;
    capf[d] = clampi(cap[d], 0, INF_I);
    inc[d] = 0;
  }
  // an entry is active while finite and below its cap
  auto act = [&](int d) { return bt(finite, d) && inc[d] < capf[d]; };
  int rem = c;
  for (int it = 0; it < 2 * D + 2; ++it) {
    float m = BIGF;
    for (int d = 0; d < D; ++d) m = fminf(m, act(d) ? __fadd_rn(vf[d], (float)inc[d]) : BIGF);
    int kmin = 0, headroom = INF_I;
    float nxt = BIGF;
    for (int d = 0; d < D; ++d) {
      bool ac = act(d);
      float cur = ac ? __fadd_rn(vf[d], (float)inc[d]) : BIGF;
      if (cur == m && ac) { kmin++; headroom = min(headroom, capf[d] - inc[d]); }
      if (cur > m) nxt = fminf(nxt, cur);
    }
    float gap = nxt < BIGF / 2 ? __fsub_rn(nxt, m) : BIGF;
    float quota = floorf(__fdiv_rn((float)rem, (float)max(kmin, 1)));
    int dd = (int)fminf(fminf(gap, (float)headroom), quota);
    dd = kmin > 0 ? max(dd, 0) : 0;
    for (int d = 0; d < D; ++d)
      if (act(d) && __fadd_rn(vf[d], (float)inc[d]) == m) inc[d] = wadd(inc[d], dd);
    rem = wsub(rem, wmul(dd, kmin));
  }
  float m = BIGF;
  for (int d = 0; d < D; ++d) m = fminf(m, act(d) ? __fadd_rn(vf[d], (float)inc[d]) : BIGF);
  int pos = 0;
  for (int d = 0; d < D; ++d) {
    if (act(d) && __fadd_rn(vf[d], (float)inc[d]) == m) {
      if (pos < rem) inc[d] += 1;
      pos++;
    }
    if (!bt(finite, d)) inc[d] = 0;
  }
}

// joint multi-group water-fill over the item's keyed member groups
template <class C>
__device__ __forceinline__ void waterfill_multi(const C& k, const PackArgs& a, const Item& I, const uint32_t* avail,
                                                int c) {
  const int D = a.D, ng = I.n_zmm, nw = k.nw();
  const int m = max(ng, 1);
  int* fz = k.wf_a;
  int* pg = k.wf_b;
  int* ug = k.wf_c;
  int* inc = k.inc;
  int* lvl = k.lvl;
  int* react = k.react;
  uint32_t* ok = k.t0mask(7);
  uint32_t* is_min = k.t0mask(8);
  uint32_t* reg_all = k.t0mask(10);
  auto reg = [&](int t) { return k.reg_bits + (size_t)I.zmm[t] * nw; };
  auto wf_ok = [&](int t) { return k.wf_ok + (size_t)t * nw; };
  for (int t = 0; t < ng; ++t) {
    int g = I.zmm[t];
    int md = a.group_min_domains[g];
    int nzr = 0;
    for (int w = 0; w < nw; ++w) nzr += __popc(reg(t)[w] & I.za[w]);
    fz[t] = md > 0 && nzr < md;
  }
  for (int d = 0; d < D; ++d) inc[d] = 0;
  int rem = c;
#define CG(t, d) (k.cz[(size_t)I.zmm[t] * D + (d)] + inc[d])
  while (rem > 0) {
    for (int w = 0; w < nw; ++w) ok[w] = full_word(D, w);
    for (int d = 0; d < D; ++d) lvl[d] = 0;
    for (int t = 0; t < ng; ++t) {
      int g = I.zmm[t];
      const uint32_t* rg = reg(t);
      int zmin = INF_I;
      for (int d = 0; d < D; ++d)
        if (bt(rg, d) && bt(I.za, d)) zmin = min(zmin, CG(t, d));
      if (zmin >= INF_I) zmin = 0;
      if (fz[t]) zmin = 0;
      uint32_t* okg = wf_ok(t);
      for (int w = 0; w < nw; ++w) okg[w] = 0;
      for (int d = 0; d < D; ++d) {
        int cg = CG(t, d);
        if (cg + 1 - zmin <= a.group_skew[g] && bt(rg, d)) bset(okg, d);
        lvl[d] += cg;
      }
      for (int w = 0; w < nw; ++w) ok[w] &= okg[w];
    }
    auto active = [&](int d) { return bt(avail, d) && bt(ok, d); };
    int mlvl = INF_I;
    for (int d = 0; d < D; ++d)
      if (active(d)) mlvl = min(mlvl, lvl[d]);
    for (int w = 0; w < nw; ++w) is_min[w] = 0;
    for (int d = 0; d < D; ++d)
      if (active(d) && lvl[d] == mlvl) bset(is_min, d);
    int kmin = popc_m(is_min, nw);
    if (kmin == 0) break;
    int nxt = INF_I;
    for (int d = 0; d < D; ++d)
      if (active(d) && lvl[d] > mlvl) nxt = min(nxt, lvl[d]);
    int d_gap = nxt < INF_I ? -floordiv(-(nxt - mlvl), m) : INF_I;
    int d_head = INF_I;
    for (int t = 0; t < ng; ++t) {
      int g = I.zmm[t];
      const uint32_t* rg = reg(t);
      int p = INF_I, u = INF_I;
      for (int d = 0; d < D; ++d) {
        if (!(bt(rg, d) && bt(I.za, d))) continue;
        if (bt(is_min, d)) p = min(p, CG(t, d));
        else u = min(u, CG(t, d));
      }
      if (fz[t]) u = 0;
      pg[t] = p;
      ug[t] = u;
      for (int d = 0; d < D; ++d)
        if (bt(is_min, d)) d_head = min(d_head, u < INF_I ? a.group_skew[g] + u - CG(t, d) : INF_I);
    }
    for (int d = 0; d < D; ++d) {
      int rmax = 0;
      bool inf = false;
      for (int t = 0; t < ng; ++t) {
        int g = I.zmm[t];
        bool blocking = !bt(wf_ok(t), d) && bt(reg(t), d);
        if (!blocking) continue;
        int thr = CG(t, d) + 1 - a.group_skew[g];
        int kk = (ug[t] >= thr && pg[t] < INF_I && !fz[t]) ? max(thr - pg[t], 1) : INF_I;
        rmax = max(rmax, kk);
        if (kk >= INF_I) inf = true;
      }
      react[d] = inf ? INF_I : rmax;
    }
    for (int w = 0; w < nw; ++w) reg_all[w] = full_word(D, w);
    for (int t = 0; t < ng; ++t)
      for (int w = 0; w < nw; ++w) reg_all[w] &= reg(t)[w];
    int d_react = INF_I;
    for (int d = 0; d < D; ++d) {
      if (!(bt(avail, d) && !bt(ok, d) && bt(reg_all, d))) continue;  // rejoinable
      int rc = min(react[d], 1 << 20);
      bool mid = lvl[d] < min(mlvl, 1 << 20) + (rc - 1) * m;
      int safe = react[d] >= INF_I ? INF_I : (mid ? react[d] - 1 : react[d]);
      d_react = min(d_react, safe);
    }
    bool partial = rem < kmin || d_react < 1;
    int dd = min(min(d_gap, d_head), min(d_react, floordiv(rem, max(kmin, 1))));
    dd = max(dd, 1);
    if (partial) {
      int first = 0;
      while (!bt(is_min, first)) ++first;
      inc[first] += 1;
      rem -= 1;
    } else {
      for (int d = 0; d < D; ++d)
        if (bt(is_min, d)) inc[d] += dd;
      rem = wsub(rem, wmul(dd, kmin));
    }
  }
#undef CG
}

__device__ __forceinline__ Place mk_place(int cnt, int el, const uint32_t* selp, int selz, const uint32_t* narp,
                                          int narz, const uint32_t* restrict_mask, int rk, bool want_blocked = false) {
  Place p;
  p.cnt = cnt;
  p.el = el;
  p.selp = selp;
  p.selz = selz;
  p.narp = narp;
  p.narz = narz;
  p.restrict_mask = restrict_mask;
  p.rk = rk;
  p.want_blocked = want_blocked;
  return p;
}

// thread 0 publishes an int to every thread (one barrier); the masks it
// wrote into k.pub(b, .) beforehand are published with it. Returns b.
__device__ __forceinline__ int publish(Smem& s, int& pc, int& v) {
  const int b = pc & 1;
  if (threadIdx.x == 0) s.pub_i[b] = v;
  __syncthreads();
  ++pc;
  v = s.pub_i[b];
  return b;
}

// -- the kernel ----------------------------------------------------------------

// one item's record, open caps, rows, compat and host-blocked bits into
// buffer b by asynchronous copies (the caller waits before its barrier)
template <class C>
__device__ __forceinline__ void prefetch_item(const C& k, const PackArgs& a, int i, int b) {
  const int tid = threadIdx.x, QD = a.Q * a.D, Nr = a.Nrows, rw = k.rl.words;
  const int4* rec = reinterpret_cast<const int4*>(k.g_recs + (size_t)i * rw);
  int4* dst = reinterpret_cast<int4*>(k.irec + (size_t)b * rw);
  for (int c = tid; c < rw / 4; c += NT) cp_async16(dst + c, rec + c);
  for (int e = tid; e < QD; e += NT) cp_async4(k.iopen + (size_t)b * QD + e, k.g_opencap + (size_t)i * QD + e);
  for (int r = tid; r < k.rt; r += NT) {
    cp_async4(k.irowinfo + (size_t)b * k.rt + r, k.g_rowinfo + (size_t)i * Nr + r);
    cp_async4(k.irowkey + (size_t)b * k.rt + r, a.choose_key + (size_t)i * Nr + r);
  }
  for (int e = tid; e < k.nrw; e += NT) cp_async4(k.icbits + (size_t)b * k.nrw + e, k.g_cbits + (size_t)i * k.nrw + e);
  for (int e = tid; e < k.nb; e += NT) cp_async4(k.ihbw + (size_t)b * k.nb + e, k.g_hbw + (size_t)i * k.nb + e);
}

// item i's view: its buffer b in shared memory, or its data in global memory
template <class C>
__device__ __forceinline__ ItemView view_of(const C& k, const PackArgs& a, int i, int b) {
  const int QD = a.Q * a.D, Nr = a.Nrows;
  ItemView V;
  V.g_rowinfo = k.g_rowinfo + (size_t)i * Nr;
  V.g_rowkey = a.choose_key + (size_t)i * Nr;
  if (C::kFits) {
    V.I = item_of(k.rl, k.irec + (size_t)b * k.rl.words);
    V.opencap = k.iopen + (size_t)b * QD;
    V.rowinfo = k.irowinfo + (size_t)b * k.rt;
    V.rowkey = k.irowkey + (size_t)b * k.rt;
    V.cbits = k.icbits + (size_t)b * k.nrw;
    V.hbw = k.ihbw + (size_t)b * k.nb;
  } else {
    V.I = item_of(k.rl, k.g_recs + (size_t)i * k.rl.words);
    V.opencap = k.g_opencap + (size_t)i * QD;
    V.rowinfo = V.g_rowinfo;
    V.rowkey = V.g_rowkey;
    V.cbits = k.g_cbits + (size_t)i * k.nrw;
    V.hbw = k.g_hbw + (size_t)i * k.nb;
  }
  return V;
}

__host__ __device__ inline size_t r4(size_t n) { return (n + 3) & ~(size_t)3; }

// The scan policy of a single scan block (K2): every slot in one block, the
// slot-axis reductions block-wide.
struct BlockExchange {
  static constexpr bool kSharded = false;
  static constexpr int kStaticExtra = 0;  // static shared memory the policy adds
  // words of dynamic shared memory the policy adds (bit-set words, scan blocks)
  static __host__ __device__ __forceinline__ int x_words(int, int) { return 0; }
  // before the scan reads the item data (after the item blocks' count)
  template <class C>
  static __device__ __forceinline__ void wait_items(const C&) {}
  // the scan blocks' last step
  template <class C>
  static __device__ __forceinline__ void finish(const C&) {}
};

// A sharded policy's static shared state: the shard block's exchange count
// and the reduced values.
struct XShared {
  unsigned ep;
  unsigned v[4];
};

// The kernel's body: logical blocks [0, nscan) scan (one block, or one per
// shard of the slot axis under a sharded policy X), the others build the
// items' data first. A launch's block b is logical block first + b: a
// launch of the scan blocks and item blocks together has first = 0; a launch
// of the item blocks alone has first = nscan, and a launch of the scan
// blocks alone (grid nscan) then finds no item block to wait for.
template <int NW, bool FITS, class X>
__device__ __forceinline__ void pack_scan_body(const PackArgs& a, int nscan, int first = 0) {
  __shared__ Smem s;
  extern __shared__ __align__(16) uint32_t dyn[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int blk = first + (int)blockIdx.x;           // the logical block
  const int n_item = first + (int)gridDim.x - nscan;  // item blocks of this launch
  const int N = a.N, D = a.D, G = a.G, R = a.R, Q = a.Q, Nr = a.Nrows, W = a.W;
  const Layout L =
      layout_of(N, Nr, R, Q, D, G, a.Kd, a.nw, a.n_existing, N / nscan, X::kStaticExtra,
                X::x_words(a.nw, nscan));
  const Scratch S = scratch_of(L, W, N, Nr, Q, D, nscan);
  uint32_t* scratch = (uint32_t*)a.scratch;
  uint32_t* spill = scratch + S.spill + (size_t)blk * L.spill_w;
  Ctx<NW, FITS, X::kSharded> k;
  k.nw_rt = a.nw;
  const int nw = k.nw();
  k.cz = a.counts_zone;
  if constexpr (X::kSharded) {
    // shard blk: slots [lo, hi), its own counts_zone and open count
    const int n_loc = N / nscan;
    k.shard = blk;
    k.nshard = nscan;
    k.lo = blk * n_loc;
    k.hi = k.lo + n_loc;
    k.xw = xw_of(nw);
    k.xbar = scratch + S.xbar;
    k.xparts = X::x_words(nw, nscan) > 0 ? dyn + L.xpart : scratch + S.xparts;
    if (blk < nscan) k.cz = a.counts_zone + (size_t)blk * G * D;
  }
  k.tile = L.tile;
  k.rt = L.rt;
  k.nch = L.nch;
  k.nrw = L.nrw;
  k.nb = L.nb;
  k.N = N;
  k.rl = L.rl;
  // the slot tile
  uint32_t* p = dyn + L.slots;
  k.sb = (int*)p; p += L.tile;
  k.sr = (int*)p; p += L.tile;
  k.stk = (int*)p; p += L.tile;
  k.stki = (int*)p; p += L.tile;
  k.stkv = (int*)p; p += L.tile;
  k.smask = p; p += 4 * (size_t)nw * L.tile;
  k.srem = (float*)p;
  // the row tile (and the item buffers' rows)
  p = dyn + L.rows;
  k.rowrank = (int*)p; p += L.rt;
  k.rmask = p; p += 3 * (size_t)nw * L.rt;
  k.irowinfo = (int*)p; p += L.fits ? 2 * (size_t)L.rt : 0;
  k.irowkey = (float*)p;
  // constants and thread-0 scratch
  uint32_t* c0 = (FITS ? dyn : spill) + L.consts;
  k.keymask = c0 + L.keymask;
  k.rank_bits = c0 + L.rank_bits;
  k.reg_bits = c0 + L.reg_bits;
  k.gkind = (int*)(c0 + L.gkind);
  k.gskew = (int*)(c0 + L.gskew);
  k.rdcap = (float*)(c0 + L.rdcap);
  k.dcls = c0 + L.dcls;
  int* t0i = (int*)(c0 + L.t0i);
  k.inc = t0i;
  k.placed_z = t0i + D;
  k.vsum = t0i + 2 * D;
  k.capd = t0i + 3 * D;
  k.wcap = t0i + 4 * D;
  k.lvl = t0i + 5 * D;
  k.react = t0i + 6 * D;
  k.wv = (float*)(c0 + L.wv);
  k.wf_a = (int*)(c0 + L.wf);
  k.wf_b = k.wf_a + G;
  k.wf_c = k.wf_b + G;
  k.wf_ok = c0 + L.wf_ok;
  k.t0m = c0 + L.t0m;
  k.pubm = c0 + L.pubm;
  k.xblk = c0 + L.xblk;
  k.xtot = (FITS ? dyn : spill) + L.xtot;
  // item buffers
  if (FITS) {
    p = dyn + L.item;
    k.irec = p; p += 2 * (size_t)L.rl.words;
    k.iopen = (int*)p; p += 2 * r4((size_t)Q * D);
    k.icbits = p; p += 2 * r4(L.nrw);
    k.ihbw = p;
  } else {
    k.irec = nullptr;
  }
  // far slots' masks and takes
  k.gmask = scratch + S.far;
  k.gtk = (int*)(k.gmask + 4 * (size_t)nw * N);
  k.g_recs = scratch + S.recs;
  k.g_opencap = (int*)(scratch + S.opencap);
  k.g_rowinfo = (int*)(scratch + S.rowinfo);
  k.g_cbits = scratch + S.cbits;
  k.g_hbw = scratch + S.hbw;

  // constants: key, rank and registration masks, group kinds and skews, the
  // rank caps and their classes; the row tile's ranks and port masks
  for (int e = tid; e < a.Kd * nw; e += NT) {
    const int kk = e / nw, w = e - kk * nw;
    uint32_t km = 0;
    for (int d = 32 * w; d < min(D, 32 * w + 32); ++d) km |= (uint32_t)(a.dom_key_of[d] == kk) << (d - 32 * w);
    k.keymask[e] = km;
  }
  for (int e = tid; e < Q * nw; e += NT) k.rank_bits[e] = plane_word(a.rank_domset, e / nw, D, e % nw);
  for (int e = tid; e < G * nw; e += NT) k.reg_bits[e] = plane_word(a.group_registered, e / nw, D, e % nw);
  for (int g = tid; g < G; g += NT) {
    k.gkind[g] = a.group_kind[g];
    k.gskew[g] = a.group_skew[g];
  }
  for (int r = tid; r < k.rt; r += NT) k.rowrank[r] = a.row_pool_rank[r];
  for (int e = tid; e < 3 * nw * k.rt; e += NT) {
    const int pw = e / k.rt, r = e - pw * k.rt, pl = pw / nw, w = pw - pl * nw;
    k.rmask[e] = pl == RP_SPEC ? plane_word(a.row_port_spec, r, a.P2, w)
                               : plane_word(pl == RP_ANY ? a.row_port_any : a.row_port_wild, r, a.P1, w);
  }
  for (int e = tid; e < Q * D * R; e += NT) k.rdcap[e] = a.rank_dom_cap[e];
  for (int e = tid; e < Q * D * nw; e += NT) {
    const int qd = e / nw, w = e - qd * nw;
    const float* mine = a.rank_dom_cap + (size_t)qd * R;
    const float* row0 = a.rank_dom_cap + (size_t)(qd / D) * D * R;
    uint32_t cls = 0;
    for (int d = 32 * w; d < min(D, 32 * w + 32); ++d) {
      bool same = true;
      for (int r = 0; r < R; ++r) same = same && __float_as_int(row0[d * R + r]) == __float_as_int(mine[r]);
      cls |= (uint32_t)same << (d - 32 * w);
    }
    k.dcls[e] = cls;
  }

  // blocks nscan.. build what an item needs that does not depend on the
  // carry, for all items, one warp per item (`item_prologue`), and count
  // themselves done; blocks 0..nscan-1 run the scan
  unsigned* done = scratch + S.done;
  if (blk >= nscan) {
    __syncthreads();  // the constants
    const int stride = n_item * NWARP;
    for (int i = (blk - nscan) * NWARP + warp; i < W; i += stride)
      item_prologue(k, a, i, k.g_recs + (size_t)i * L.rl.words, k.g_opencap + (size_t)i * Q * D);
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(done, 1u);
    return;
  }

  // the open slots' state: the tile into shared memory, domain and port
  // planes into masks
  int oc = a.open_count[X::kSharded ? k.shard : 0];
  const int oc_in = min(oc, N);
  for (int j = tid; j < k.tile; j += NT) k.stki[j] = -1;
  for (int j = k.base() + tid; j < k.act(oc_in); j += NT) {
    for (int w = 0; w < nw; ++w) {
      sm_at(k, ZS, j, w) = plane_word(a.slot_zoneset, j, D, w);
      sm_at(k, PA, j, w) = plane_word(a.slot_pany, j, a.P1, w);
      sm_at(k, PW, j, w) = plane_word(a.slot_pwild, j, a.P1, w);
      sm_at(k, PS, j, w) = plane_word(a.slot_pspec, j, a.P2, w);
    }
    const int jl = j - k.base();
    if (jl < k.tile) {
      k.sb[jl] = a.slot_basis[j];
      k.sr[jl] = a.slot_rank[j];
      for (int r = 0; r < R; ++r) k.srem[(size_t)r * k.tile + jl] = a.slot_rem[(size_t)j * R + r];
    }
  }
  __syncthreads();

  // wait for the item blocks (co-resident: the launch is cooperative); a
  // block that never ran would trap here instead of hanging the card. A
  // launch without item blocks waits as its policy says.
  X::wait_items(k);
  if (tid == 0) {
    const long long t0 = clock64();
    while (atomicAdd(done, 0u) < (unsigned)n_item) {
      __nanosleep(256);
      if (clock64() - t0 > (1LL << 34)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
  if (W > 0 && FITS) prefetch_item(k, a, 0, 0);
  cp_async_wait_all();
  __syncthreads();

  int xc = 0, pc = 0;
  for (int i = 0; i < W; ++i) {
    const int bi = i & 1;
    if (i + 1 < W && FITS) prefetch_item(k, a, i + 1, bi ^ 1);  // lands while item i runs
    const ItemView V = view_of(k, a, i, bi);
    const Item& I = V.I;

    int pending;
    const int branch = I.branch;
    if (branch == 0) {
      // simple path
      pending = place<X>(k, a, s, V, mk_place(I.c, EL_ALL, nullptr, 0, I.za, 0, I.rs_all, RK_ALL), i, oc, xc).left;
    } else if (branch == 1) {
      // zone path: slot capacity per domain, water-fill, per-domain fill and
      // redistribution of stranded quota
      const int gb = xc & 1;
      gany_zero(k, gb);
      for (int j = k.base() + tid; j < k.act(oc); j += NT) {
        if (slot_compat(k, a, V, j) && int_cap_slot(k, a, j, I.req) > 0 && port_ok(k, I, j) &&
            perkey_ok(k, I.za, [&](int w) { return sm_at(k, ZS, j, w); }, I.rs_other))
          for (int w = 0; w < nw; ++w) gany_or(k, gb, w, sm_at(k, ZS, j, w));
      }
      __syncthreads();
      ++xc;
      if constexpr (X::kSharded) X::gany(k, gb);
      // thread 0: the water-fill; zone scalars for the redistribution
      int skew_star = INF_I, multi = I.n_zmm > 1, force_zero = 0;
      uint32_t* allowed_real = k.t0mask(1);
      uint32_t* available = k.t0mask(2);
      uint32_t* finite = k.t0mask(3);
      uint32_t* reg_all = k.t0mask(4);
      if (tid == 0) {
        int md_star = 0;
        uint32_t* reg_star = k.t0mask(5);
        for (int w = 0; w < nw; ++w) {
          reg_star[w] = 0;
          reg_all[w] = full_word(D, w);
        }
        for (int d = 0; d < D; ++d) k.vsum[d] = 0;
        for (int t = 0; t < I.n_zmm; ++t) {
          int g = I.zmm[t];
          for (int d = 0; d < D; ++d) k.vsum[d] = wadd(k.vsum[d], k.cz[(size_t)g * D + d]);
          if (a.group_kind[g] == K_DOM_SPREAD) skew_star = min(skew_star, a.group_skew[g]);
          for (int w = 0; w < nw; ++w) {
            reg_star[w] |= k.reg_bits[(size_t)g * nw + w];
            reg_all[w] &= k.reg_bits[(size_t)g * nw + w];
          }
          md_star = max(md_star, a.group_min_domains[g]);
        }
        for (int w = 0; w < nw; ++w) {
          allowed_real[w] = I.za[w] & reg_star[w] & I.kmask[w];
          available[w] = allowed_real[w] & (I.openable[w] | gany_word(k, gb, w));
        }
        if (multi) {
          spread_ok_bits(k, a, I, finite);
          for (int w = 0; w < nw; ++w) finite[w] &= available[w];
        } else {
          for (int w = 0; w < nw; ++w) finite[w] = available[w];
        }
        int frozen_min = INF_I;
        for (int d = 0; d < D; ++d)
          if (bt(allowed_real, d) && !bt(available, d)) frozen_min = min(frozen_min, k.vsum[d]);
        int supported = popc_m(allowed_real, nw);
        force_zero = md_star > 0 && supported < md_star;
        if (force_zero) frozen_min = 0;
        for (int d = 0; d < D; ++d) k.capd[d] = clampi(wsub(wadd(frozen_min, skew_star), k.vsum[d]), 0, INF_I);
        if (multi) waterfill_multi(k, a, I, available, I.c);
        else waterfill(k, a, k.vsum, finite, I.c, k.capd);
        for (int d = 0; d < D; ++d) k.placed_z[d] = 0;
      }
      __syncthreads();  // k.inc
      pending = I.c;
      for (int d = 0; d < D; ++d) pending = wsub(pending, k.inc[d]);
      for (int z = 0; z < D; ++z) {
        const int cz = k.inc[z];
        const int left =
            place<X>(k, a, s, V, mk_place(cz, EL_ZONE, nullptr, z, nullptr, z, I.rs_other, RK_BITS), i, oc, xc).left;
        pending = wadd(pending, left);
        if (tid == 0) k.placed_z[z] = wsub(cz, left);
      }
      for (int z = 0; z < D; ++z) {
        int cz = 0;
        if (tid == 0) {
          int headroom;
          if (multi) {
            int head = INF_I;
            for (int t = 0; t < I.n_zmm; ++t) {
              int g = I.zmm[t];
              const uint32_t* rg = k.reg_bits + (size_t)g * nw;
              int zmin = INF_I, nzr = 0;
              for (int d = 0; d < D; ++d)
                if (bt(I.za, d) && bt(rg, d)) {
                  zmin = min(zmin, wadd(k.cz[(size_t)g * D + d], k.placed_z[d]));
                  ++nzr;
                }
              if (zmin >= INF_I) zmin = 0;
              int md = a.group_min_domains[g];
              if (md > 0 && nzr < md) zmin = 0;
              int h = wsub(wadd(zmin, a.group_skew[g]), wadd(k.cz[(size_t)g * D + z], k.placed_z[z]));
              head = min(head, h);
            }
            headroom = clampi(bt(reg_all, z) && bt(available, z) ? head : 0, 0, INF_I);
          } else {
            int zmin = INF_I;
            for (int d = 0; d < D; ++d)
              if (bt(allowed_real, d)) zmin = min(zmin, wadd(k.vsum[d], k.placed_z[d]));
            if (zmin >= INF_I) zmin = 0;
            if (force_zero) zmin = 0;
            int h = clampi(wsub(wadd(zmin, skew_star), wadd(k.vsum[z], k.placed_z[z])), 0, INF_I);
            headroom = bt(finite, z) ? h : 0;
          }
          cz = min(pending, headroom);
        }
        publish(s, pc, cz);
        const int left =
            place<X>(k, a, s, V, mk_place(cz, EL_ZONE, nullptr, z, nullptr, z, I.rs_other, RK_BITS), i, oc, xc).left;
        const int placed = wsub(cz, left);
        pending = wsub(pending, placed);
        if (tid == 0) k.placed_z[z] = wadd(k.placed_z[z], placed);
      }
      if (tid == 0) {
        for (int t = 0; t < I.n_zmm; ++t)
          for (int d = 0; d < D; ++d) {
            int* pz = k.cz + (size_t)I.zmm[t] * D + d;
            *pz = wadd(*pz, k.placed_z[d]);
          }
      }
    } else if (branch == 2) {
      // keyed anti-affinity: D+1 single-pod rounds, each placement blocks
      // every domain its slot could still land in
      uint32_t* reg_star = k.t0mask(5);
      if (tid == 0)
        for (int w = 0; w < nw; ++w) {
          reg_star[w] = 0;
          for (int t = 0; t < I.n_zmm; ++t) reg_star[w] |= k.reg_bits[(size_t)I.zmm[t] * nw + w];
        }
      pending = I.c;
      for (int round = 0; round <= D; ++round) {
        int unused = 0;
        const int pb = pc & 1;
        uint32_t* empty = k.pub(pb, 0);
        uint32_t* narrow = k.pub(pb, 1);
        if (tid == 0) {
          for (int w = 0; w < nw; ++w) empty[w] = 0;
          for (int d = 0; d < D; ++d) {
            int v = 0;
            for (int t = 0; t < I.n_zmm; ++t) v = wadd(v, k.cz[(size_t)I.zmm[t] * D + d]);
            if (v == 0) bset(empty, d);
          }
          for (int w = 0; w < nw; ++w) {
            empty[w] &= reg_star[w] & I.za[w] & I.kmask[w];
            narrow[w] = (I.kmask[w] & empty[w]) | (~I.kmask[w] & I.za[w]);
          }
        }
        publish(s, pc, unused);
        const int cnt = min(pending, 1);
        const Placed r =
            place<X>(k, a, s, V, mk_place(cnt, EL_ANTI, empty, 0, narrow, 0, I.rs_other, RK_BITS, true), i, oc, xc);
        if (tid == 0) {
          for (int d = 0; d < D; ++d)
            if (bt(I.kmask, d) && ((gany_word(k, r.blk, d >> 5) >> (d & 31)) & 1u))
              for (int t = 0; t < I.n_zmm; ++t) {
                int* pz = k.cz + (size_t)I.zmm[t] * D + d;
                *pz = wadd(*pz, 1);
              }
        }
        pending = wsub(pending, wsub(cnt, r.left));
      }
    } else if (branch == 3) {
      // required affinity over a domain key: recorded domains, else one
      // bootstrap domain
      int n_aff = 0;
      const int pb = pc & 1;
      uint32_t* allowed_rec = k.pub(pb, 0);
      uint32_t* bootstrapable = k.pub(pb, 1);
      if (tid == 0) {
        uint32_t* reg_star = k.t0mask(5);
        for (int w = 0; w < nw; ++w) reg_star[w] = 0;
        for (int d = 0; d < D; ++d) k.vsum[d] = 0;
        for (int t = 0; t < I.n_zmm; ++t) {
          int g = I.zmm[t];
          if (a.group_kind[g] != K_DOM_AFF) continue;
          k.wf_a[n_aff++] = g;
          for (int w = 0; w < nw; ++w) reg_star[w] |= k.reg_bits[(size_t)g * nw + w];
          for (int d = 0; d < D; ++d) k.vsum[d] = wadd(k.vsum[d], k.cz[(size_t)g * D + d]);
        }
        for (int w = 0; w < nw; ++w) {
          bootstrapable[w] = I.za[w] & I.kmask[w] & reg_star[w];
          allowed_rec[w] = 0;
        }
        for (int d = 0; d < D; ++d)
          if (k.vsum[d] > 0 && bt(bootstrapable, d)) bset(allowed_rec, d);
        for (int d = 0; d < D; ++d) k.placed_z[d] = 0;
      }
      publish(s, pc, n_aff);
      const bool any_rec = any_m(allowed_rec, nw);
      int boot = -1;
      pending = I.c;
      for (int z = 0; z < D; ++z) {
        const bool active = any_rec ? bt(allowed_rec, z) : (boot >= 0 ? boot == z : bt(bootstrapable, z));
        const int cnt = active ? pending : 0;
        const int left =
            place<X>(k, a, s, V, mk_place(cnt, EL_ZONE, nullptr, z, nullptr, z, I.rs_other, RK_BITS), i, oc, xc).left;
        const int placed = wsub(cnt, left);
        pending = wsub(pending, placed);
        if (tid == 0) k.placed_z[z] = wadd(k.placed_z[z], placed);
        if (!any_rec && boot < 0 && placed > 0) boot = z;
      }
      if (tid == 0) {
        for (int t = 0; t < n_aff; ++t)
          for (int d = 0; d < D; ++d) {
            int* pz = k.cz + (size_t)k.wf_a[t] * D + d;
            *pz = wadd(*pz, k.placed_z[d]);
          }
      }
    } else {
      // required hostname affinity: recorded hosts, else one bootstrap host.
      // Without owned affinity groups every slot counts as recorded.
      bool any_rec;
      if (I.n_haff == 0) {
        any_rec = N > 0;
      } else {
        const int gb = xc & 1;
        gany_zero(k, gb);
        bool rec = false;
        for (int j = k.base() + tid; j < k.act(oc); j += NT) rec |= rec_ok(a, I, j);
        gany_or(k, gb, 0, rec ? 1u : 0u);
        __syncthreads();
        ++xc;
        if constexpr (X::kSharded) X::gany(k, gb);
        any_rec = gany_word(k, gb, 0) != 0;
      }
      const int boot = any_rec ? 0 : min(I.c, 1);
      const int left1 =
          place<X>(k, a, s, V, mk_place(boot, EL_ALL, nullptr, 0, I.za, 0, I.rs_all, RK_ALL), i, oc, xc).left;
      const int rest = wsub(I.c, wsub(boot, left1));
      pending = place<X>(k, a, s, V, mk_place(rest, EL_REC, nullptr, 0, I.za, 0, I.rs_all, RK_NONE), i, oc, xc).left;
    }
    if (tid == 0 && (!X::kSharded || k.shard == 0)) a.leftovers[i] = pending;
    cp_async_wait_all();  // item i+1's data
    __syncthreads();
  }

  // the open slots back to the carry: the tile's state, every mask as planes
  const int oc_out = min(oc, N);
  for (int j = k.base() + tid; j < k.act(oc_out); j += NT) {
    const int jl = j - k.base();
    if (jl < k.tile) {
      a.slot_basis[j] = k.sb[jl];
      a.slot_rank[j] = k.sr[jl];
      for (int r = 0; r < R; ++r) a.slot_rem[(size_t)j * R + r] = k.srem[(size_t)r * k.tile + jl];
    }
    for (int d = 0; d < D; ++d) a.slot_zoneset[(size_t)j * D + d] = (sm_at(k, ZS, j, d >> 5) >> (d & 31)) & 1u;
    for (int x = 0; x < a.P1; ++x) {
      a.slot_pany[(size_t)j * a.P1 + x] = (sm_at(k, PA, j, x >> 5) >> (x & 31)) & 1u;
      a.slot_pwild[(size_t)j * a.P1 + x] = (sm_at(k, PW, j, x >> 5) >> (x & 31)) & 1u;
    }
    for (int x = 0; x < a.P2; ++x) a.slot_pspec[(size_t)j * a.P2 + x] = (sm_at(k, PS, j, x >> 5) >> (x & 31)) & 1u;
  }
  if (tid == 0) a.open_count[X::kSharded ? k.shard : 0] = oc;
  X::finish(k);
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
  a.nw = max(1, max(max(words_of(a.D), words_of(a.Kd)), max(max(words_of(a.P1), words_of(a.P2)), words_of(a.Q))));
}

// the layout of a launch with n_scan scan blocks (each N / n_scan slots)
// under policy X
template <class X>
static Layout layout_of_args(const PackArgs& a, int n_scan) {
  return layout_of(a.N, a.Nrows, a.R, a.Q, a.D, a.G, a.Kd, a.nw, a.n_existing, a.N / n_scan, X::kStaticExtra,
                   X::x_words(a.nw, n_scan));
}
