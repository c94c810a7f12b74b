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
// pods (allowed domains, constrained keys, the constrained key's domains,
// their groups by role) into bit masks in `pod_info`. Per step:
//   - all threads: the first open slot that fits (slots past open_count
//     are closed: slots open in order, so only [0, open_count) is read;
//     each thread strides over it and stops at its first fit), and the
//     masked argmin of the K1 key over the rows (ties to the lowest row;
//     masked-out rows take the value BIG and still win ties below the
//     first fitting row, so a winner that does not fit means -1, exactly as
//     `masked_argmin`); warp shuffles, then one partial per warp;
//   - thread 0: the choice of slot, the domain commitment (cur_domset,
//     dom_cost, z_star, new_domset over D <= 32 as bit masks), the update
//     of slot j and of counts_dom / counts_host (only the groups the pod
//     belongs to), then the next pod's dom_feasible (spread_ok_of over its
//     keyed groups only) and rank_ok, published through shared memory.
// The state lives in global memory (counts_host is [G, N], 16 x 5120
// int32 at the headline), except counts_dom, which sits in shared memory
// during the scan. Domain sets are 32-bit masks during the scan and are
// written back to the bool carry at the end. Bit-parity with the
// reference: rem_j is one IEEE f32 subtraction (built with -fmad=false),
// int32 sums wrap in unsigned arithmetic, ties go to the lowest index
// everywhere, and z_star is 0 (the NO_ZONE sentinel) when every domain
// costs INF.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define NWARP (NT / 32)
#define MAX_R 16
#define MAX_G 64
#define MAX_Q 32
#define MAX_D 32
#define MAX_KD 32
#define INF_I (1 << 30)
#define BIGF 3.4e38f
#define NO_FIT 0x7fffffff

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
  uint32_t* domset_bits;           // [N]     scratch
  unsigned long long* pod_info;    // [P, 8]  scratch
  int P, N, Nrows, R, D, G, Q, Kd, n_existing, n_rows_real;
};

// pod_info layout, 8 x 64 bits per pod
enum { PI_MASKS = 0, PI_DM = 1, PI_SPREAD = 2, PI_ANTI = 3, PI_HOST = 4, PI_OWN_HS = 5, PI_OWN_HA = 6, PI_KEYS = 7 };

struct Smem {
  // constants of the problem
  uint32_t keymask[MAX_KD];   // domains of each dom key
  uint32_t rank_bits[MAX_Q];  // rank_domset as masks
  uint32_t reg_bits[MAX_G];   // group_registered as masks
  int kind[MAX_G], skew[MAX_G], min_dom[MAX_G];
  int counts_dom[MAX_G * MAX_D];
  // the current pod, published by thread 0
  float req[MAX_R];
  uint32_t za, restrict_bits, kmask, dom_feasible, rank_ok;
  int dm;  // is_dom_member
  unsigned long long own_hs, own_ha;
  int open;
  // per-warp partials of the step's reductions
  int w_slot[NWARP];
  float w_v[NWARP];
  int w_i[NWARP];
  int w_f[NWARP];
};

__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

// perkey_dom_ok for one domain set: every constrained key keeps an allowed domain
__device__ __forceinline__ bool perkey_ok(const Smem& s, uint32_t set, uint32_t za, uint32_t restrict_bits) {
  uint32_t inter = set & za;
  for (uint32_t k = restrict_bits; k; k &= k - 1)
    if (!(inter & s.keymask[__ffs(k) - 1])) return false;
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

// thread 0: publish pod i's per-step values (dom_feasible from the current
// counts_dom, rank_ok) for the next parallel phase
__device__ __forceinline__ void prepare_pod(const PerPodArgs& a, Smem& s, int i) {
  const unsigned long long* info = a.pod_info + (size_t)i * 8;
  uint32_t za = (uint32_t)info[PI_MASKS];
  uint32_t restrict_bits = (uint32_t)(info[PI_MASKS] >> 32);
  uint32_t kmask = (uint32_t)info[PI_KEYS];
  unsigned long long dm_groups = info[PI_DM];
  int dm = dm_groups != 0ull;
  uint32_t all_d = a.D >= 32 ? 0xffffffffu : ((1u << a.D) - 1u);
  uint32_t spread_ok = all_d;
  for (unsigned long long gm = dm_groups; gm; gm &= gm - 1) {
    int g = __ffsll((long long)gm) - 1;
    const int* cd = s.counts_dom + g * MAX_D;
    uint32_t reg = s.reg_bits[g];
    uint32_t zr = za & reg;
    int zmin = INF_I;
    for (uint32_t d = zr; d; d &= d - 1) zmin = min(zmin, cd[__ffs(d) - 1]);
    if (zmin >= INF_I) zmin = 0;
    if (s.min_dom[g] > 0 && __popc(zr) < s.min_dom[g]) zmin = 0;
    uint32_t ok = 0;
    for (int d = 0; d < a.D; ++d) {
      bool o = s.kind[g] == K_DOM_ANTI ? cd[d] == 0 : (int)((unsigned)cd[d] + 1u - (unsigned)zmin) <= s.skew[g];
      if (o) ok |= 1u << d;
    }
    spread_ok &= ok & reg;
  }
  uint32_t dom_feasible = dm ? (za & spread_ok) : za;
  uint32_t rank_ok = 0;
  for (int q = 0; q < a.Q; ++q) {
    uint32_t rb = s.rank_bits[q];
    if (perkey_ok(s, rb, za, restrict_bits) && (!dm || (rb & dom_feasible))) rank_ok |= 1u << q;
  }
  for (int r = 0; r < a.R; ++r) s.req[r] = a.pod_req[(size_t)i * a.R + r];
  s.za = za;
  s.restrict_bits = restrict_bits;
  s.kmask = kmask;
  s.dm = dm;
  s.dom_feasible = dom_feasible;
  s.rank_ok = rank_ok;
  s.own_hs = info[PI_OWN_HS];
  s.own_ha = info[PI_OWN_HA];
}

__global__ void __launch_bounds__(NT, 1) perpod_pack_kernel(PerPodArgs a) {
  __shared__ Smem s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.R, D = a.D, G = a.G, N = a.N, Nrows = a.Nrows;

  // -- constants, the carry's domain sets as masks, and the pods' facts ---
  for (int k = tid; k < a.Kd; k += NT) {
    uint32_t m = 0;
    for (int d = 0; d < D; ++d)
      if (a.dom_key_of[d] == k) m |= 1u << d;
    s.keymask[k] = m;
  }
  for (int q = tid; q < a.Q; q += NT) {
    uint32_t m = 0;
    for (int d = 0; d < D; ++d)
      if (a.rank_domset[q * D + d]) m |= 1u << d;
    s.rank_bits[q] = m;
  }
  for (int g = tid; g < G; g += NT) {
    uint32_t m = 0;
    for (int d = 0; d < D; ++d) {
      if (a.group_registered[g * D + d]) m |= 1u << d;
      s.counts_dom[g * MAX_D + d] = a.counts_dom[g * D + d];
    }
    s.reg_bits[g] = m;
    s.kind[g] = a.group_kind[g];
    s.skew[g] = a.group_skew[g];
    s.min_dom[g] = a.group_min_domains[g];
  }
  for (int j = tid; j < N; j += NT) {
    uint32_t m = 0;
    for (int d = 0; d < D; ++d)
      if (a.slot_domset[(size_t)j * D + d]) m |= 1u << d;
    a.domset_bits[j] = m;
  }
  for (int i = tid; i < a.P; i += NT) {
    uint32_t za = 0, rs = 0;
    for (int d = 0; d < D; ++d)
      if (a.pod_dom_allowed[(size_t)i * D + d]) za |= 1u << d;
    for (int k = 0; k < a.Kd; ++k)
      if (a.pod_restrict[(size_t)i * a.Kd + k]) rs |= 1u << k;
    unsigned long long dm = 0, spread = 0, anti = 0, host = 0, own_hs = 0, own_ha = 0;
    int k_star = -1;
    for (int g = 0; g < G; ++g) {
      unsigned long long bit = 1ull << g;
      int kind = a.group_kind[g];
      if (a.member[(size_t)i * G + g]) {
        if (kind == K_DOM_SPREAD || kind == K_DOM_ANTI) {
          dm |= bit;
          k_star = max(k_star, a.group_dom_key[g]);
        }
        if (kind == K_DOM_SPREAD) spread |= bit;
        if (kind == K_DOM_ANTI) anti |= bit;
        if (kind == K_HOST_SPREAD || kind == K_HOST_ANTI) host |= bit;
      }
      if (a.owner[(size_t)i * G + g]) {
        if (kind == K_HOST_SPREAD) own_hs |= bit;
        if (kind == K_HOST_ANTI) own_ha |= bit;
      }
    }
    uint32_t kmask = 0;
    for (int d = 0; d < D; ++d)
      if (a.dom_key_of[d] == k_star) kmask |= 1u << d;
    unsigned long long* info = a.pod_info + (size_t)i * 8;
    info[PI_MASKS] = (unsigned long long)za | ((unsigned long long)rs << 32);
    info[PI_DM] = dm;
    info[PI_SPREAD] = spread;
    info[PI_ANTI] = anti;
    info[PI_HOST] = host;
    info[PI_OWN_HS] = own_hs;
    info[PI_OWN_HA] = own_ha;
    info[PI_KEYS] = kmask;
  }
  __syncthreads();
  int oc = a.open_count[0];  // thread 0's copy is the one that counts
  if (tid == 0) {
    s.open = oc;
    if (a.P > 0) prepare_pod(a, s, 0);
  }

  for (int i = 0; i < a.P; ++i) {
    __syncthreads();  // the state and pod i's values are published
    const uint8_t* compat_i = a.compat + (size_t)i * Nrows;
    const float* key_i = a.choose_key + (size_t)i * Nrows;
    const int open = s.open;
    const uint32_t za = s.za, rs = s.restrict_bits, dfeas = s.dom_feasible;
    const int dm = s.dm;
    const unsigned long long own_hs = s.own_hs, own_ha = s.own_ha;

    // first open slot that fits (each thread's first fit is its lowest)
    int best_j = NO_FIT;
    for (int j = tid; j < open; j += NT) {
      int b = a.slot_basis[j];
      bool f = b >= 0;
      for (int r = 0; r < R && f; ++r) f = s.req[r] <= a.slot_rem[(size_t)j * R + r];
      f = f && compat_i[min(max(b, 0), Nrows - 1)];
      if (f) {
        uint32_t ds = a.domset_bits[j];
        f = perkey_ok(s, ds, za, rs) && (!dm || (ds & dfeas));
      }
      for (unsigned long long gm = own_hs; gm && f; gm &= gm - 1) {
        int g = __ffsll((long long)gm) - 1;
        f = wrap_add(a.counts_host[(size_t)g * N + j], 1) <= s.skew[g];
      }
      for (unsigned long long gm = own_ha; gm && f; gm &= gm - 1) {
        int g = __ffsll((long long)gm) - 1;
        f = a.counts_host[(size_t)g * N + j] == 0;
      }
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
      for (int k = 0; k < R && f; ++k) f = s.req[k] <= a.row_alloc[(size_t)r * R + k];
      f = f && ((s.rank_ok >> min(max(a.row_pool_rank[r], 0), a.Q - 1)) & 1u);
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
        const unsigned long long* info = a.pod_info + (size_t)i * 8;
        const uint32_t kmask = s.kmask;
        const int safe_o = min(max(o_new, 0), Nrows - 1);
        const int rank_o = a.row_pool_rank[safe_o];
        uint32_t cur = use_slot ? a.domset_bits[j] : s.rank_bits[min(max(rank_o, 0), a.Q - 1)];
        uint32_t m = dm ? kmask : 0u;
        cur &= (dfeas & m) | (za & ~m);
        // dom_cost: the keyed groups' counts summed per domain; argmin, ties low
        unsigned long long dm_groups = info[PI_DM];
        int z_star = 0, best = 0;
        for (int d = 0; d < D; ++d) {
          int cost = INF_I;
          if ((cur & kmask) >> d & 1u) {
            unsigned sum = 0;
            for (unsigned long long gm = dm_groups; gm; gm &= gm - 1)
              sum += (unsigned)s.counts_dom[(__ffsll((long long)gm) - 1) * MAX_D + d];
            cost = (int)sum;
          }
          if (d == 0 || cost < best) {
            best = cost;
            z_star = d;
          }
        }
        unsigned long long spread_groups = info[PI_SPREAD];
        uint32_t new_set = cur;
        if (dm && spread_groups) new_set = ((kmask & (1u << z_star)) | (cur & ~kmask)) & cur;

        if (!use_slot) a.slot_basis[j] = o_new;
        for (int r = 0; r < R; ++r) {
          float base = use_slot ? a.slot_rem[(size_t)j * R + r] : a.row_alloc[(size_t)safe_o * R + r];
          a.slot_rem[(size_t)j * R + r] = __fsub_rn(base, s.req[r]);
        }
        a.domset_bits[j] = new_set;
        if (!use_slot) {
          a.slot_rank[j] = rank_o;
          ++oc;
        }
        if (dm)
          for (unsigned long long gm = spread_groups; gm; gm &= gm - 1) {
            int* c = &s.counts_dom[(__ffsll((long long)gm) - 1) * MAX_D + z_star];
            *c = wrap_add(*c, 1);
          }
        uint32_t blocked = new_set & kmask;
        for (unsigned long long gm = info[PI_ANTI]; gm; gm &= gm - 1) {
          int g = __ffsll((long long)gm) - 1;
          for (uint32_t d = blocked; d; d &= d - 1) {
            int* c = &s.counts_dom[g * MAX_D + __ffs(d) - 1];
            *c = wrap_add(*c, 1);
          }
        }
        for (unsigned long long gm = info[PI_HOST]; gm; gm &= gm - 1) {
          int* c = &a.counts_host[(size_t)(__ffsll((long long)gm) - 1) * N + j];
          *c = wrap_add(*c, 1);
        }
      }
      s.open = oc;
      if (i + 1 < a.P) prepare_pod(a, s, i + 1);
    }
  }

  // -- write the carry back ------------------------------------------------
  __syncthreads();
  for (int j = tid; j < N; j += NT) {
    uint32_t m = a.domset_bits[j];
    for (int d = 0; d < D; ++d) a.slot_domset[(size_t)j * D + d] = (m >> d) & 1u;
  }
  for (int g = tid; g < G; g += NT)
    for (int d = 0; d < D; ++d) a.counts_dom[g * D + d] = s.counts_dom[g * MAX_D + d];
  if (tid == 0) a.open_count[0] = s.open;
}

extern "C" int kt_perpod_pack(const long long* ptrs, const int* dims, void* stream) {
  PerPodArgs a;
  const void** p = reinterpret_cast<const void**>(&a);
  const int n_ptrs = 26;
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
  perpod_pack_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int kt_perpod_pack_limits(int* out) {
  out[0] = MAX_R;
  out[1] = MAX_G;
  out[2] = MAX_Q;
  out[3] = MAX_D;
  out[4] = MAX_KD;
  return 0;
}
