// K2 pack_scan: the signature-grouped FFD pack scan, one persistent block.
//
// Replaces: karpenter_tpu/models/scheduler_model_grouped.py `_pack_body`
// (:450-994) as run by `_pack_compressed_impl` (:1028): the lax.scan over W
// signature items with its five lax.switch branches (simple / zone / anti /
// dom-affinity / host-affinity), `place` (:657), `_int_cap`/`_int_cap_nd`
// (:295/:303), `_waterfill` (:311) and `_waterfill_multi` (:346).
//
// What bounds it on an H100: not bytes (the whole carry plus the [W, N]
// take matrix is ~11 MB at the headline shape, ~3 us at 3.35 TB/s) and not
// arithmetic, but the sequential chain: item i+1 reads the carry item i
// wrote, and each `place` needs two block-wide scans/reductions over the N
// slots plus a best-row argmin, each a __syncthreads round.
//
// Design: one block of 1024 threads walks the items in order (the carry
// makes the item axis sequential, so a grid would only add grid-wide
// barriers). Slot work is thread-strided over N with a fixed owner thread
// per slot, so per-slot state needs no barrier between phases; the
// first-fit prefix sum, sums, ORs and the argmin use CUB block primitives
// with a running offset across 1024-slot chunks. Per-item scalar logic
// (branch choice, water-fills over D domains, group bookkeeping) runs in
// thread 0 and publishes through shared memory. Domain sets and port sets
// are held as 32-bit masks during the scan (D, P1, P2 <= 32) and written
// back to the u8 carry planes at the end. Bit-parity with the reference:
// IEEE division and no FMA contraction (built with -fmad=false, explicit
// __f*_rn), int32 wraparound done in unsigned arithmetic, floor division
// for the reference's `//`, ties to the lowest index everywhere.
// Making it fast (slot state in shared memory / a cluster with DSMEM for
// the three slot-axis reductions) is later work.

#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <stdint.h>

#define NT 1024
#define MAX_R 16
#define MAX_G 256
#define MAX_Q 32
#define MAX_D 32
#define MAX_KD 32
#define INF_I (1 << 30)
#define BIGF 3.4e38f

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
  int* scratch;                    // [5 N + 5 Nrows]
  int W, N, Nrows, R, D, G, Q, Kd, P1, P2, HB, n_existing, n_rows_real;
};

struct ArgMin {
  float v;
  int i;
};
struct ArgMinOp {
  __device__ ArgMin operator()(const ArgMin& a, const ArgMin& b) const {
    return (b.v < a.v || (b.v == a.v && b.i < a.i)) ? b : a;
  }
};
struct OrOp {
  __device__ unsigned operator()(unsigned a, unsigned b) const { return a | b; }
};

typedef cub::BlockScan<unsigned, NT> BScan;
typedef cub::BlockReduce<unsigned, NT> BRedU;
typedef cub::BlockReduce<ArgMin, NT> BRedA;

struct Smem {
  union {
    typename BScan::TempStorage scan;
    typename BRedU::TempStorage redu;
    typename BRedA::TempStorage reda;
  } temp;
  unsigned bc_u;
  ArgMin bc_a;
  // constants of the problem
  uint32_t keymask[MAX_KD];   // domains of each dom key
  uint32_t rank_bits[MAX_Q];  // rank_domset as masks
  uint32_t reg_bits[MAX_G];   // group_registered as masks
  // per item
  float req[MAX_R];
  uint32_t za, kmask, restrict_all, restrict_other, pany, pwild, pspec;
  uint32_t spread_ok, openable, rank_fits[MAX_Q];
  uint8_t rank_ok_all[MAX_Q], rank_ok_other[MAX_Q];
  int open_cap_d[MAX_Q][MAX_D];
  int c, port_cap, host_cap_new, k_star, branch;
  int n_zmm, zmm[MAX_G];          // keyed-domain member groups
  int n_hown, hown[MAX_G];        // hostname gate groups the item owns
  int n_hmem, hmem[MAX_G];        // hostname-counted groups the item is in
  int n_haff, haff[MAX_G];        // hostname-affinity groups the item owns
  int wf_a[MAX_G], wf_b[MAX_G], wf_c[MAX_G];  // water-fill per-group scratch
  uint32_t wf_ok[MAX_G];
  int inc[MAX_D], placed_z[MAX_D], vsum[MAX_D];
  // one place() call: parameters (thread 0 writes) and results
  int p_cnt, p_el, p_rk;
  uint32_t p_elbits, p_restrict, p_narrow, p_rkbits;
  int p_left, p_o, p_cstar, p_m, p_oc0;
  uint32_t p_newzs, p_blocked;
  int open_count;
  // path locals shared across the per-domain loop
  int pending, any_rec, boot;
  uint32_t allowed_rec, bootstrapable, reg_star, allowed_real, available, finite, reg_all_members;
  int skew_star, multi, force_zero;
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

// min over requested resources of floor(rem / req), clipped to [0, 2^30]
__device__ int int_cap(const float* rem, const float* req, int R) {
  float cap = BIGF;
  for (int r = 0; r < R; ++r) {
    float s = req[r] > 0.f ? floorf(__fdiv_rn(rem[r], fmaxf(req[r], 1e-9f))) : BIGF;
    cap = fminf(cap, s);
  }
  cap = fminf(fmaxf(cap, 0.f), 1073741824.f);
  return (int)cap;
}

__device__ bool perkey_ok(const Smem& s, uint32_t zs, uint32_t restrict_mask) {
  uint32_t inter = zs & s.za;
  while (restrict_mask) {
    int k = __ffs(restrict_mask) - 1;
    restrict_mask &= restrict_mask - 1;
    if ((inter & s.keymask[k]) == 0) return false;
  }
  return true;
}

__device__ unsigned block_sum(Smem& s, unsigned v) {
  unsigned r = BRedU(s.temp.redu).Sum(v);
  if (threadIdx.x == 0) s.bc_u = r;
  __syncthreads();
  unsigned out = s.bc_u;
  __syncthreads();
  return out;
}

__device__ unsigned block_or(Smem& s, unsigned v) {
  unsigned r = BRedU(s.temp.redu).Reduce(v, OrOp());
  if (threadIdx.x == 0) s.bc_u = r;
  __syncthreads();
  unsigned out = s.bc_u;
  __syncthreads();
  return out;
}

__device__ ArgMin block_argmin(Smem& s, ArgMin v) {
  ArgMin r = BRedA(s.temp.reda).Reduce(v, ArgMinOp());
  if (threadIdx.x == 0) s.bc_a = r;
  __syncthreads();
  ArgMin out = s.bc_a;
  __syncthreads();
  return out;
}

struct Scratch {
  uint32_t *zs, *pa, *pw, *ps;
  int* tk;
  int* fits_row;
  int* row_cap;
  uint32_t *rpa, *rpw, *rps;
};

__device__ __forceinline__ Scratch carve(const PackArgs& a) {
  Scratch c;
  int N = a.N, Nr = a.Nrows;
  c.zs = (uint32_t*)a.scratch;
  c.pa = c.zs + N;
  c.pw = c.pa + N;
  c.ps = c.pw + N;
  c.tk = (int*)(c.ps + N);
  c.fits_row = c.tk + N;
  c.row_cap = c.fits_row + Nr;
  c.rpa = (uint32_t*)(c.row_cap + Nr);
  c.rpw = c.rpa + Nr;
  c.rps = c.rpw + Nr;
  return c;
}

__device__ __forceinline__ bool slot_compat(const PackArgs& a, int i, int j) {
  int b = a.slot_basis[j];
  if (b < 0) return false;
  if (!a.compat[(size_t)i * a.Nrows + clampi(b, 0, a.Nrows - 1)]) return false;
  bool blocked = j < a.n_existing && a.item_host_blocked[(size_t)i * a.HB + clampi(j, 0, a.HB - 1)];
  return !blocked;
}

__device__ __forceinline__ bool port_ok(const Smem& s, const Scratch& sc, int j) {
  return ((sc.pa[j] & s.pwild) | (sc.pw[j] & s.pany) | (sc.ps[j] & s.pspec)) == 0;
}

__device__ __forceinline__ bool rec_ok(const PackArgs& a, const Smem& s, int j) {
  for (int t = 0; t < s.n_haff; ++t)
    if (a.counts_host[(size_t)s.haff[t] * a.N + j] <= 0) return false;
  return true;
}

// per-slot capacity of one place() call (0 where ineligible)
__device__ int slot_cap(const PackArgs& a, const Smem& s, const Scratch& sc, int i, int j) {
  if (!slot_compat(a, i, j)) return 0;
  uint32_t zs = sc.zs[j];
  if (!perkey_ok(s, zs, s.p_restrict)) return 0;
  if ((s.p_el == EL_ZONE || s.p_el == EL_ANTI) && (zs & s.p_elbits) == 0) return 0;
  if (s.p_el == EL_REC && !rec_ok(a, s, j)) return 0;
  if (!port_ok(s, sc, j)) return 0;
  const int R = a.R;
  const float* rem = a.slot_rem + (size_t)j * R;
  int cap_res = int_cap(rem, s.req, R);
  int rank = a.slot_rank[j];
  int cap_dom;
  if (rank < 0) {
    cap_dom = INF_I;
  } else {
    int rb = clampi(a.slot_basis[j], 0, a.Nrows - 1);
    int rq = clampi(rank, 0, a.Q - 1);
    float total[MAX_R];
    for (int r = 0; r < R; ++r) total[r] = __fsub_rn(a.row_alloc[(size_t)rb * R + r], rem[r]);
    cap_dom = 0;
    uint32_t target = zs & s.p_narrow;
    while (target) {
      int d = __ffs(target) - 1;
      target &= target - 1;
      float rnd[MAX_R];
      const float* cap = a.rank_dom_cap + ((size_t)rq * a.D + d) * R;
      for (int r = 0; r < R; ++r) rnd[r] = __fsub_rn(cap[r], total[r]);
      cap_dom = max(cap_dom, int_cap(rnd, s.req, R));
    }
  }
  int mhc = INF_I;
  for (int t = 0; t < s.n_hown; ++t) {
    int g = s.hown[t];
    int ch = a.counts_host[(size_t)g * a.N + j];
    int v = a.group_kind[g] == K_HOST_SPREAD ? wsub(a.group_skew[g], ch) : (ch == 0 ? 1 : 0);
    mhc = min(mhc, v);
  }
  int capj = min(min(min(cap_res, cap_dom), mhc), s.port_cap);
  return clampi(capj, 0, INF_I);
}

// Place s.p_cnt identical pods (parameters in s.p_*): prefix-sum first-fit
// over eligible slots, then fresh slots of the best row for the leftover.
// Results: s.p_left, s.p_blocked (OR of touched slots' narrowed sets).
__device__ void place(const PackArgs& a, Smem& s, const Scratch& sc, int i) {
  const int tid = threadIdx.x, N = a.N, R = a.R;
  const int cnt = s.p_cnt;
  unsigned run = 0, local = 0;
  for (int base = 0; base < N; base += NT) {
    int j = base + tid;
    int cap = j < N ? slot_cap(a, s, sc, i, j) : 0;
    unsigned pre, agg;
    BScan(s.temp.scan).ExclusiveSum((unsigned)cap, pre, agg);
    __syncthreads();
    if (j < N) {
      int x = wsub(cnt, (int)(pre + run));
      int take = min(max(x, 0), cap);
      sc.tk[j] = take;
      local += (unsigned)take;
    }
    run += agg;
  }
  int left = wsub(cnt, (int)block_sum(s, local));

  // best row: argmin of the choose key over fitting rows of admitted ranks
  ArgMin best = {__int_as_float(0x7f800000), 0x7fffffff};
  for (int r = tid; r < a.Nrows; r += NT) {
    int q = clampi(a.row_pool_rank[r], 0, a.Q - 1);
    bool rk = s.p_rk == RK_ALL ? s.rank_ok_all[q] != 0
              : s.p_rk == RK_NONE ? false
                                  : ((s.rank_bits[q] & s.p_rkbits) != 0 && s.rank_ok_other[q] != 0);
    bool cap_ok = (s.rank_bits[q] & s.p_narrow & s.rank_fits[q]) != 0;
    bool fr = sc.fits_row[r] != 0 && rk && cap_ok;
    float v = fr ? a.choose_key[(size_t)i * a.Nrows + r] : BIGF;
    if (v < best.v || (v == best.v && r < best.i)) { best.v = v; best.i = r; }
  }
  ArgMin ob = block_argmin(s, best);
  if (tid == 0) {
    int o = ob.i;
    int q = clampi(a.row_pool_rank[o], 0, a.Q - 1);
    bool rk = s.p_rk == RK_ALL ? s.rank_ok_all[q] != 0
              : s.p_rk == RK_NONE ? false
                                  : ((s.rank_bits[q] & s.p_rkbits) != 0 && s.rank_ok_other[q] != 0);
    bool o_ok = sc.fits_row[o] != 0 && rk && (s.rank_bits[q] & s.p_narrow & s.rank_fits[q]) != 0;
    int cap_open = 0;
    uint32_t sel = s.rank_bits[q] & s.p_narrow;
    while (sel) {
      int d = __ffs(sel) - 1;
      sel &= sel - 1;
      cap_open = max(cap_open, s.open_cap_d[q][d]);
    }
    int cstar = min(min(min(sc.row_cap[o], cap_open), s.host_cap_new), s.port_cap);
    bool can_open = o_ok && cstar >= 1;
    int m = can_open ? -floordiv(-left, max(cstar, 1)) : 0;
    m = min(max(m, 0), N - s.open_count);
    s.p_o = o;
    s.p_cstar = cstar;
    s.p_m = m;
    s.p_oc0 = s.open_count;
    s.p_newzs = s.rank_bits[q] & s.p_narrow;
    s.p_left = left;
  }
  __syncthreads();
  const int o = s.p_o, cstar = s.p_cstar, m = s.p_m, oc0 = s.p_oc0;
  const uint32_t narrow = s.p_narrow, newzs = s.p_newzs;
  unsigned local_new = 0, blocked = 0;
  for (int j = tid; j < N; j += NT) {
    int take = sc.tk[j];
    if (j >= oc0 && j < oc0 + m) {
      int x = wsub(left, wmul(j - oc0, cstar));
      int nt = min(max(x, 0), cstar);
      local_new += (unsigned)nt;
      take += nt;
      a.slot_basis[j] = o;
      a.slot_rank[j] = a.row_pool_rank[o];
      for (int r = 0; r < R; ++r) a.slot_rem[(size_t)j * R + r] = a.row_alloc[(size_t)o * R + r];
      sc.zs[j] = newzs;
      sc.pa[j] = sc.rpa[o];
      sc.pw[j] = sc.rpw[o];
      sc.ps[j] = sc.rps[o];
    }
    if (take > 0) {
      uint32_t z = sc.zs[j] & narrow;
      sc.zs[j] = z;
      float tf = (float)take;
      for (int r = 0; r < R; ++r) {
        float* p = a.slot_rem + (size_t)j * R + r;
        *p = __fsub_rn(*p, __fmul_rn(tf, s.req[r]));
      }
      for (int t = 0; t < s.n_hmem; ++t) {
        int* ch = a.counts_host + (size_t)s.hmem[t] * N + j;
        *ch = wadd(*ch, take);
      }
      sc.pa[j] |= s.pany;
      sc.pw[j] |= s.pwild;
      sc.ps[j] |= s.pspec;
      int* tp = a.takes + (size_t)i * N + j;
      *tp = wadd(*tp, take);
      blocked |= z;
    }
  }
  unsigned new_sum = block_sum(s, local_new);
  unsigned blk = block_or(s, blocked);
  if (tid == 0) {
    s.p_left = wsub(s.p_left, (int)new_sum);
    s.p_blocked = blk;
    s.open_count = wadd(s.open_count, m);
  }
  __syncthreads();
}

// -- thread-0 helpers --------------------------------------------------------

__device__ uint32_t spread_ok_bits(const PackArgs& a, const Smem& s) {
  const int D = a.D;
  uint32_t ok = full_mask(D);
  for (int t = 0; t < s.n_zmm; ++t) {
    int g = s.zmm[t];
    uint32_t reg = s.reg_bits[g], zr = s.za & reg;
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
__device__ void waterfill(const PackArgs& a, Smem& s, const int* v, uint32_t finite, int c, const int* cap) {
  const int D = a.D;
  float vf[MAX_D];
  int capf[MAX_D], inc[MAX_D];
  for (int d = 0; d < D; ++d) {
    vf[d] = ((finite >> d) & 1u) ? (float)v[d] : BIGF;
    capf[d] = clampi(cap[d], 0, INF_I);
    inc[d] = 0;
  }
  int rem = c;
  for (int it = 0; it < 2 * D + 2; ++it) {
    float cur[MAX_D];
    bool act[MAX_D];
    float m = BIGF;
    for (int d = 0; d < D; ++d) {
      act[d] = ((finite >> d) & 1u) && inc[d] < capf[d];
      cur[d] = act[d] ? __fadd_rn(vf[d], (float)inc[d]) : BIGF;
      m = fminf(m, cur[d]);
    }
    int kmin = 0, headroom = INF_I;
    float nxt = BIGF;
    for (int d = 0; d < D; ++d) {
      bool im = cur[d] == m && act[d];
      if (im) { kmin++; headroom = min(headroom, capf[d] - inc[d]); }
      if (cur[d] > m) nxt = fminf(nxt, cur[d]);
    }
    float gap = nxt < BIGF / 2 ? __fsub_rn(nxt, m) : BIGF;
    float quota = floorf(__fdiv_rn((float)rem, (float)max(kmin, 1)));
    int dd = (int)fminf(fminf(gap, (float)headroom), quota);
    dd = kmin > 0 ? max(dd, 0) : 0;
    for (int d = 0; d < D; ++d)
      if (cur[d] == m && act[d]) inc[d] = wadd(inc[d], dd);
    rem = wsub(rem, wmul(dd, kmin));
  }
  float cur[MAX_D];
  bool act[MAX_D];
  float m = BIGF;
  for (int d = 0; d < D; ++d) {
    act[d] = ((finite >> d) & 1u) && inc[d] < capf[d];
    cur[d] = act[d] ? __fadd_rn(vf[d], (float)inc[d]) : BIGF;
    m = fminf(m, cur[d]);
  }
  int pos = 0;
  for (int d = 0; d < D; ++d) {
    if (cur[d] == m && act[d]) {
      if (pos < rem) inc[d] += 1;
      pos++;
    }
    s.inc[d] = ((finite >> d) & 1u) ? inc[d] : 0;
  }
}

// joint multi-group water-fill over the item's keyed member groups
__device__ void waterfill_multi(const PackArgs& a, Smem& s, uint32_t avail, int c) {
  const int D = a.D, ng = s.n_zmm;
  const int m = max(ng, 1);
  int* fz = s.wf_a;
  int* pg = s.wf_b;
  int* ug = s.wf_c;
  for (int t = 0; t < ng; ++t) {
    int g = s.zmm[t];
    int md = a.group_min_domains[g];
    fz[t] = md > 0 && __popc(s.reg_bits[g] & s.za) < md;
  }
  int inc[MAX_D];
  for (int d = 0; d < D; ++d) inc[d] = 0;
  int rem = c;
#define CG(t, d) (a.counts_zone[(size_t)s.zmm[t] * D + (d)] + inc[d])
  while (rem > 0) {
    uint32_t ok = full_mask(D);
    int lvl[MAX_D];
    for (int d = 0; d < D; ++d) lvl[d] = 0;
    for (int t = 0; t < ng; ++t) {
      int g = s.zmm[t];
      uint32_t reg = s.reg_bits[g], regm = reg & s.za;
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
      int g = s.zmm[t];
      uint32_t regm = s.reg_bits[g] & s.za;
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
    int react[MAX_D];
    for (int d = 0; d < D; ++d) {
      int rmax = 0;
      bool inf = false;
      for (int t = 0; t < ng; ++t) {
        int g = s.zmm[t];
        bool blocking = !((s.wf_ok[t] >> d) & 1u) && ((s.reg_bits[g] >> d) & 1u);
        if (!blocking) continue;
        int thr = CG(t, d) + 1 - a.group_skew[g];
        int k = (ug[t] >= thr && pg[t] < INF_I && !fz[t]) ? max(thr - pg[t], 1) : INF_I;
        rmax = max(rmax, k);
        if (k >= INF_I) inf = true;
      }
      react[d] = inf ? INF_I : rmax;
    }
    for (int t = 0; t < ng; ++t) reg_all &= s.reg_bits[s.zmm[t]];
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
  for (int d = 0; d < D; ++d) s.inc[d] = inc[d];
}

__device__ __forceinline__ uint32_t narrow_of(const Smem& s, int z) {
  return (s.kmask & (1u << z)) | (s.za & ~s.kmask);
}

__device__ __forceinline__ void set_place(Smem& s, int cnt, int el, uint32_t elbits, uint32_t restrict_mask,
                                          uint32_t narrow, int rk, uint32_t rkbits) {
  s.p_cnt = cnt;
  s.p_el = el;
  s.p_elbits = elbits;
  s.p_restrict = restrict_mask;
  s.p_narrow = narrow;
  s.p_rk = rk;
  s.p_rkbits = rkbits;
}

// -- the kernel ----------------------------------------------------------------

__global__ void __launch_bounds__(NT, 1) pack_scan_kernel(PackArgs a) {
  __shared__ Smem s;
  const int tid = threadIdx.x;
  const int N = a.N, D = a.D, G = a.G, R = a.R, Q = a.Q, Nr = a.Nrows;
  Scratch sc = carve(a);

  // carry planes -> bit masks; constant masks
  for (int j = tid; j < N; j += NT) {
    uint32_t z = 0, pa = 0, pw = 0, ps = 0;
    for (int d = 0; d < D; ++d) z |= (uint32_t)(a.slot_zoneset[(size_t)j * D + d] != 0) << d;
    for (int p = 0; p < a.P1; ++p) {
      pa |= (uint32_t)(a.slot_pany[(size_t)j * a.P1 + p] != 0) << p;
      pw |= (uint32_t)(a.slot_pwild[(size_t)j * a.P1 + p] != 0) << p;
    }
    for (int p = 0; p < a.P2; ++p) ps |= (uint32_t)(a.slot_pspec[(size_t)j * a.P2 + p] != 0) << p;
    sc.zs[j] = z;
    sc.pa[j] = pa;
    sc.pw[j] = pw;
    sc.ps[j] = ps;
  }
  for (int r = tid; r < Nr; r += NT) {
    uint32_t pa = 0, pw = 0, ps = 0;
    for (int p = 0; p < a.P1; ++p) {
      pa |= (uint32_t)(a.row_port_any[(size_t)r * a.P1 + p] != 0) << p;
      pw |= (uint32_t)(a.row_port_wild[(size_t)r * a.P1 + p] != 0) << p;
    }
    for (int p = 0; p < a.P2; ++p) ps |= (uint32_t)(a.row_port_spec[(size_t)r * a.P2 + p] != 0) << p;
    sc.rpa[r] = pa;
    sc.rpw[r] = pw;
    sc.rps[r] = ps;
  }
  if (tid == 0) {
    for (int k = 0; k < a.Kd; ++k) {
      uint32_t km = 0;
      for (int d = 0; d < D; ++d) km |= (uint32_t)(a.dom_key_of[d] == k) << d;
      s.keymask[k] = km;
    }
    for (int q = 0; q < Q; ++q) {
      uint32_t b = 0;
      for (int d = 0; d < D; ++d) b |= (uint32_t)(a.rank_domset[q * D + d] != 0) << d;
      s.rank_bits[q] = b;
    }
    for (int g = 0; g < G; ++g) {
      uint32_t b = 0;
      for (int d = 0; d < D; ++d) b |= (uint32_t)(a.group_registered[g * D + d] != 0) << d;
      s.reg_bits[g] = b;
    }
    s.open_count = a.open_count[0];
  }
  __syncthreads();

  for (int i = 0; i < a.W; ++i) {
    // ---- per-item prologue (thread 0) --------------------------------------
    if (tid == 0) {
      for (int r = 0; r < R; ++r) s.req[r] = a.item_req[(size_t)i * R + r];
      uint32_t za = 0, rs = 0, pa = 0, pw = 0, ps = 0;
      for (int d = 0; d < D; ++d) za |= (uint32_t)(a.item_dom_allowed[(size_t)i * D + d] != 0) << d;
      for (int k = 0; k < a.Kd; ++k) rs |= (uint32_t)(a.item_restrict[(size_t)i * a.Kd + k] != 0) << k;
      for (int p = 0; p < a.P1; ++p) {
        pa |= (uint32_t)(a.item_port_any[(size_t)i * a.P1 + p] != 0) << p;
        pw |= (uint32_t)(a.item_port_wild[(size_t)i * a.P1 + p] != 0) << p;
      }
      for (int p = 0; p < a.P2; ++p) ps |= (uint32_t)(a.item_port_spec[(size_t)i * a.P2 + p] != 0) << p;
      s.za = za;
      s.restrict_all = rs;
      s.pany = pa;
      s.pwild = pw;
      s.pspec = ps;
      s.c = a.item_count[i];
      s.port_cap = pa ? 1 : INF_I;
      int k_star = -1, hcap = INF_I;
      bool anti = false, domaff = false, hostaff = false;
      s.n_zmm = s.n_hown = s.n_hmem = s.n_haff = 0;
      for (int g = 0; g < G; ++g) {
        bool mem = a.item_member[(size_t)i * G + g] != 0;
        bool own = a.item_owner[(size_t)i * G + g] != 0;
        int kind = a.group_kind[g];
        if (mem && (kind == K_DOM_SPREAD || kind == K_DOM_ANTI || kind == K_DOM_AFF)) {
          s.zmm[s.n_zmm++] = g;
          k_star = max(k_star, a.group_dom_key[g]);
          anti |= kind == K_DOM_ANTI;
          domaff |= kind == K_DOM_AFF;
        }
        if (own && (kind == K_HOST_SPREAD || kind == K_HOST_ANTI)) {
          s.hown[s.n_hown++] = g;
          hcap = min(hcap, kind == K_HOST_SPREAD ? a.group_skew[g] : 1);
        }
        if (mem && (kind == K_HOST_SPREAD || kind == K_HOST_ANTI || kind == K_HOST_AFF)) s.hmem[s.n_hmem++] = g;
        if (own && kind == K_HOST_AFF) s.haff[s.n_haff++] = g;
        hostaff |= mem && kind == K_HOST_AFF;
      }
      s.k_star = k_star;
      s.host_cap_new = hcap;
      uint32_t km = 0;
      for (int d = 0; d < D; ++d) km |= (uint32_t)(a.dom_key_of[d] == k_star) << d;
      s.kmask = km;
      s.restrict_other = (k_star >= 0 && k_star < 32) ? (rs & ~(1u << k_star)) : rs;
      s.spread_ok = spread_ok_bits(a, s);
      for (int q = 0; q < Q; ++q) {
        s.rank_ok_all[q] = perkey_ok(s, s.rank_bits[q], s.restrict_all);
        s.rank_ok_other[q] = perkey_ok(s, s.rank_bits[q], s.restrict_other);
        uint32_t fits = 0;
        for (int d = 0; d < D; ++d) {
          int oc = int_cap(a.rank_dom_cap + ((size_t)q * D + d) * R, s.req, R);
          s.open_cap_d[q][d] = oc;
          fits |= (uint32_t)(oc >= 1) << d;
        }
        s.rank_fits[q] = fits;
      }
      s.branch = hostaff ? 4 : domaff ? 3 : anti ? 2 : (s.n_zmm > 0 ? 1 : 0);
    }
    __syncthreads();

    // ---- rows: fits_row, row_cap, openable domains ---------------------------
    {
      unsigned open_bits = 0;
      for (int r = tid; r < Nr; r += NT) {
        bool fits = r >= a.n_existing && r < a.n_rows_real && a.compat[(size_t)i * Nr + r];
        for (int k = 0; k < R && fits; ++k) fits = s.req[k] <= a.row_alloc[(size_t)r * R + k];
        fits = fits && ((sc.rpa[r] & s.pwild) | (sc.rpw[r] & s.pany) | (sc.rps[r] & s.pspec)) == 0;
        sc.fits_row[r] = fits;
        sc.row_cap[r] = int_cap(a.row_alloc + (size_t)r * R, s.req, R);
        int q = clampi(a.row_pool_rank[r], 0, Q - 1);
        if (fits && s.rank_ok_other[q]) open_bits |= s.rank_bits[q] & s.rank_fits[q];
      }
      unsigned ob = block_or(s, open_bits);
      if (tid == 0) s.openable = ob;
      __syncthreads();
    }

    const int branch = s.branch;
    if (branch == 0) {
      // simple path
      if (tid == 0) set_place(s, s.c, EL_ALL, 0, s.restrict_all, s.za, RK_ALL, 0);
      __syncthreads();
      place(a, s, sc, i);
      if (tid == 0) s.pending = s.p_left;
    } else if (branch == 1) {
      // zone path: slot capacity per domain, water-fill, per-domain fill and
      // redistribution of stranded quota
      unsigned sl = 0;
      for (int j = tid; j < N; j += NT) {
        if (slot_compat(a, i, j) && int_cap(a.slot_rem + (size_t)j * R, s.req, R) > 0 && port_ok(s, sc, j) &&
            perkey_ok(s, sc.zs[j], s.restrict_other))
          sl |= sc.zs[j];
      }
      unsigned slotcap = block_or(s, sl);
      if (tid == 0) {
        int skew_star = INF_I, md_star = 0;
        uint32_t reg_star = 0, reg_all = full_mask(D);
        for (int d = 0; d < D; ++d) s.vsum[d] = 0;
        for (int t = 0; t < s.n_zmm; ++t) {
          int g = s.zmm[t];
          for (int d = 0; d < D; ++d) s.vsum[d] = wadd(s.vsum[d], a.counts_zone[(size_t)g * D + d]);
          if (a.group_kind[g] == K_DOM_SPREAD) skew_star = min(skew_star, a.group_skew[g]);
          reg_star |= s.reg_bits[g];
          reg_all &= s.reg_bits[g];
          md_star = max(md_star, a.group_min_domains[g]);
        }
        uint32_t allowed_real = s.za & reg_star & s.kmask;
        uint32_t available = allowed_real & (s.openable | slotcap);
        int multi = s.n_zmm > 1;
        uint32_t finite = available & (multi ? s.spread_ok : 0xffffffffu);
        uint32_t frozen = allowed_real & ~available;
        int frozen_min = INF_I;
        for (int d = 0; d < D; ++d)
          if ((frozen >> d) & 1u) frozen_min = min(frozen_min, s.vsum[d]);
        int supported = __popc(s.za & reg_star & s.kmask);
        int force_zero = md_star > 0 && supported < md_star;
        if (force_zero) frozen_min = 0;
        int cap[MAX_D];
        for (int d = 0; d < D; ++d) cap[d] = clampi(wsub(wadd(frozen_min, skew_star), s.vsum[d]), 0, INF_I);
        if (multi) waterfill_multi(a, s, available, s.c);
        else waterfill(a, s, s.vsum, finite, s.c, cap);
        int sum_inc = 0;
        for (int d = 0; d < D; ++d) { sum_inc = wadd(sum_inc, s.inc[d]); s.placed_z[d] = 0; }
        s.pending = wsub(s.c, sum_inc);
        s.skew_star = skew_star;
        s.multi = multi;
        s.force_zero = force_zero;
        s.allowed_real = allowed_real;
        s.available = available;
        s.finite = finite;
        s.reg_all_members = reg_all;
      }
      __syncthreads();
      for (int z = 0; z < D; ++z) {
        if (tid == 0) set_place(s, s.inc[z], EL_ZONE, 1u << z, s.restrict_other, narrow_of(s, z), RK_BITS, 1u << z);
        __syncthreads();
        place(a, s, sc, i);
        if (tid == 0) {
          s.pending = wadd(s.pending, s.p_left);
          s.placed_z[z] = wsub(s.inc[z], s.p_left);
        }
        __syncthreads();
      }
      for (int z = 0; z < D; ++z) {
        if (tid == 0) {
          int headroom;
          if (s.multi) {
            int head = INF_I;
            for (int t = 0; t < s.n_zmm; ++t) {
              int g = s.zmm[t];
              uint32_t zr = s.za & s.reg_bits[g];
              int zmin = INF_I;
              for (int d = 0; d < D; ++d)
                if ((zr >> d) & 1u) zmin = min(zmin, wadd(a.counts_zone[(size_t)g * D + d], s.placed_z[d]));
              if (zmin >= INF_I) zmin = 0;
              int md = a.group_min_domains[g];
              if (md > 0 && __popc(zr) < md) zmin = 0;
              int h = wsub(wadd(zmin, a.group_skew[g]), wadd(a.counts_zone[(size_t)g * D + z], s.placed_z[z]));
              head = min(head, h);
            }
            headroom = clampi(((s.reg_all_members & s.available) >> z) & 1u ? head : 0, 0, INF_I);
          } else {
            int zmin = INF_I;
            for (int d = 0; d < D; ++d)
              if ((s.allowed_real >> d) & 1u) zmin = min(zmin, wadd(s.vsum[d], s.placed_z[d]));
            if (zmin >= INF_I) zmin = 0;
            if (s.force_zero) zmin = 0;
            int h = clampi(wsub(wadd(zmin, s.skew_star), wadd(s.vsum[z], s.placed_z[z])), 0, INF_I);
            headroom = ((s.finite >> z) & 1u) ? h : 0;
          }
          int cz = min(s.pending, headroom);
          set_place(s, cz, EL_ZONE, 1u << z, s.restrict_other, narrow_of(s, z), RK_BITS, 1u << z);
        }
        __syncthreads();
        place(a, s, sc, i);
        if (tid == 0) {
          int placed = wsub(s.p_cnt, s.p_left);
          s.pending = wsub(s.pending, placed);
          s.placed_z[z] = wadd(s.placed_z[z], placed);
        }
        __syncthreads();
      }
      if (tid == 0) {
        for (int t = 0; t < s.n_zmm; ++t)
          for (int d = 0; d < D; ++d) {
            int* p = a.counts_zone + (size_t)s.zmm[t] * D + d;
            *p = wadd(*p, s.placed_z[d]);
          }
      }
    } else if (branch == 2) {
      // keyed anti-affinity: D+1 single-pod rounds, each placement blocks
      // every domain its slot could still land in
      if (tid == 0) {
        uint32_t reg_star = 0;
        for (int t = 0; t < s.n_zmm; ++t) reg_star |= s.reg_bits[s.zmm[t]];
        s.reg_star = reg_star;
        s.pending = s.c;
      }
      __syncthreads();
      for (int round = 0; round <= D; ++round) {
        if (tid == 0) {
          uint32_t empty = 0;
          for (int d = 0; d < D; ++d) {
            int v = 0;
            for (int t = 0; t < s.n_zmm; ++t) v = wadd(v, a.counts_zone[(size_t)s.zmm[t] * D + d]);
            if (v == 0) empty |= 1u << d;
          }
          empty &= s.reg_star & s.za & s.kmask;
          uint32_t narrow = (s.kmask & empty) | (~s.kmask & s.za);
          set_place(s, min(s.pending, 1), EL_ANTI, empty, s.restrict_other, narrow, RK_BITS, empty);
        }
        __syncthreads();
        place(a, s, sc, i);
        if (tid == 0) {
          uint32_t blocked = s.p_blocked & s.kmask;
          for (int t = 0; t < s.n_zmm; ++t)
            for (int d = 0; d < D; ++d)
              if ((blocked >> d) & 1u) a.counts_zone[(size_t)s.zmm[t] * D + d] += 1;
          s.pending = wsub(s.pending, wsub(s.p_cnt, s.p_left));
        }
        __syncthreads();
      }
    } else if (branch == 3) {
      // required affinity over a domain key: recorded domains, else one
      // bootstrap domain
      if (tid == 0) {
        uint32_t reg_star = 0, rec = 0;
        for (int d = 0; d < D; ++d) s.vsum[d] = 0;
        int n = 0;
        for (int t = 0; t < s.n_zmm; ++t) {
          int g = s.zmm[t];
          if (a.group_kind[g] != K_DOM_AFF) continue;
          s.wf_a[n++] = g;
          reg_star |= s.reg_bits[g];
          for (int d = 0; d < D; ++d) s.vsum[d] = wadd(s.vsum[d], a.counts_zone[(size_t)g * D + d]);
        }
        s.wf_b[0] = n;
        for (int d = 0; d < D; ++d)
          if (s.vsum[d] > 0) rec |= 1u << d;
        s.allowed_rec = s.za & s.kmask & reg_star & rec;
        s.any_rec = s.allowed_rec != 0;
        s.bootstrapable = s.za & s.kmask & reg_star;
        s.pending = s.c;
        s.boot = -1;
        for (int d = 0; d < D; ++d) s.placed_z[d] = 0;
      }
      __syncthreads();
      for (int z = 0; z < D; ++z) {
        if (tid == 0) {
          bool active = s.any_rec ? ((s.allowed_rec >> z) & 1u) != 0
                                  : (s.boot >= 0 ? s.boot == z : ((s.bootstrapable >> z) & 1u) != 0);
          set_place(s, active ? s.pending : 0, EL_ZONE, 1u << z, s.restrict_other, narrow_of(s, z), RK_BITS, 1u << z);
        }
        __syncthreads();
        place(a, s, sc, i);
        if (tid == 0) {
          int placed = wsub(s.p_cnt, s.p_left);
          s.pending = wsub(s.pending, placed);
          s.placed_z[z] = wadd(s.placed_z[z], placed);
          if (!s.any_rec && s.boot < 0 && placed > 0) s.boot = z;
        }
        __syncthreads();
      }
      if (tid == 0) {
        for (int t = 0; t < s.wf_b[0]; ++t)
          for (int d = 0; d < D; ++d) {
            int* p = a.counts_zone + (size_t)s.wf_a[t] * D + d;
            *p = wadd(*p, s.placed_z[d]);
          }
      }
    } else {
      // required hostname affinity: recorded hosts, else one bootstrap host
      unsigned rec = 0;
      for (int j = tid; j < N; j += NT) rec |= rec_ok(a, s, j) ? 1u : 0u;
      unsigned any_rec = block_or(s, rec);
      if (tid == 0) set_place(s, any_rec ? 0 : min(s.c, 1), EL_ALL, 0, s.restrict_all, s.za, RK_ALL, 0);
      __syncthreads();
      place(a, s, sc, i);
      if (tid == 0) {
        int rest = wsub(s.c, wsub(s.p_cnt, s.p_left));
        set_place(s, rest, EL_REC, 0, s.restrict_all, s.za, RK_NONE, 0);
      }
      __syncthreads();
      place(a, s, sc, i);
      if (tid == 0) s.pending = s.p_left;
    }
    if (tid == 0) a.leftovers[i] = s.pending;
    __syncthreads();
  }

  // bit masks -> carry planes
  for (int j = tid; j < N; j += NT) {
    uint32_t z = sc.zs[j], pa = sc.pa[j], pw = sc.pw[j], ps = sc.ps[j];
    for (int d = 0; d < D; ++d) a.slot_zoneset[(size_t)j * D + d] = (z >> d) & 1u;
    for (int p = 0; p < a.P1; ++p) {
      a.slot_pany[(size_t)j * a.P1 + p] = (pa >> p) & 1u;
      a.slot_pwild[(size_t)j * a.P1 + p] = (pw >> p) & 1u;
    }
    for (int p = 0; p < a.P2; ++p) a.slot_pspec[(size_t)j * a.P2 + p] = (ps >> p) & 1u;
  }
  if (tid == 0) a.open_count[0] = s.open_count;
}

// ptrs: the PackArgs pointers in declaration order; dims: W, N, Nrows, R, D,
// G, Q, Kd, P1, P2, HB, n_existing, n_rows_real
extern "C" int kt_pack_scan(const long long* ptrs, const int* dims, void* stream) {
  PackArgs a;
  const void** p = reinterpret_cast<const void**>(&a);
  const int n_ptrs = 38;
  for (int k = 0; k < n_ptrs; ++k) p[k] = reinterpret_cast<const void*>(ptrs[k]);
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
  pack_scan_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int kt_pack_scan_limits(int* out) {
  out[0] = MAX_R;
  out[1] = MAX_G;
  out[2] = MAX_Q;
  out[3] = MAX_D;
  out[4] = MAX_KD;
  return 0;
}
