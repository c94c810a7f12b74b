// K1 feasibility: item x row requirement compatibility and the new-slot row
// preference key, fused.
//
// Replaces: karpenter_tpu/models/scheduler_model.py `compat_matrix` (:436,
// with ops/bitset.py `test_bit` :35) and `row_choose_key` (:454), as called
// at the top of the grouped pack (scheduler_model_grouped.py:547-548), and
// `_compat_matrix` (:503) with the in-step `row_choose_key` (:565) of the
// per-pod scan `_greedy_pack_impl`: one launch over all items or all pods.
//
// What bounds it on an H100: neither bytes nor arithmetic at the main
// path's shapes (640 items or 5000 pods x 128 rows, 0.5-4 MB moved, a
// bound of 0.2-1.2 us): the launch and chains of dependent steps, a copy
// round trip, a barrier, a few hundred instructions a warp, with few warps
// on each SM. The design keeps every item's walk over the rows in shared
// memory and each step's loads in flight together.
//
// Design: the rows are cut into tiles of 32 to TILE_MAX rows, as small as
// it takes for the (item, tile) pairs to fill the warps of two blocks on
// every SM, and no larger than leaves room for two blocks. Block (x, y)
// stages tile x's row side once: it copies (cp.async) the tile's labels as
// they lie, 16 bytes a copy where aligned, the allocs into rows of an odd
// stride, the taint classes, the ranks and the forced-key bytes, and while
// those copies fly each warp starts copying its first item. Each thread
// then turns the labels it copied into per-(row, key) codes in rows of an
// odd stride (so the lanes, on consecutive rows, read different banks)
// that fold in the test_bit semantics: -1 for a negative label id, which
// never matches, else the bit's word clamped to Words - 1, times 32, plus
// the bit. A taint class becomes the one the reference's gather reads (a
// negative one wrapped once, then clamped), a rank rank * 1e9, and warp 0
// lists the keys no dom key forces. Then each warp takes one item at a
// time, y * 8 + warp, then gridDim.y * 8 further, ... (about 2 x SM-count
// blocks in all, any number of items in one launch): the item's K x Words
// mask words, its requests (clamped to 1e-6) and tolerations are copied
// once into the warp's buffer, and each lane tests RPL rows side by side,
// 32 rows apart, writing the compat bytes and keys coalesced; a lane's key
// loop ends at the first key that leaves none of its rows compatible.
// Where a block's layout does not fit in shared memory even at 32 rows
// (very wide K x Words or R), the same code stages into the block's slice
// of a global scratch that the wrapper sizes with kt_feasibility_scratch
// (plain copies in place of cp.async).
// Bit-parity: IEEE division for the R quotients (__fdiv_rn, no
// reciprocal), fminf in the reference's order and no FMA contraction
// (built with -fmad=false, explicit __f*_rn).

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256  // threads per block: 8 warps, each one item at a time
#define NWARP (NT / 32)
#define TILE_MAX 256                 // rows a block stages at most
#define RPL 2                        // rows a lane tests side by side
#define SMEM_SOFT (100 * 1024)       // two blocks per SM where the layout allows it
#define SMEM_LIMIT (232448 - 1024)   // a block's dynamic shared memory, less the static part
#define FULL 0xffffffffu

struct Args {
  const int* row_labels;       // [Nrows, K]
  const int* row_taint_class;  // [Nrows]
  const float* row_alloc;      // [Nrows, R]
  const int* row_pool_rank;    // [Nrows]
  const uint32_t* item_mask;   // [B, K, Words]
  const uint8_t* taint_ok;     // [B, C]
  const float* item_req;       // [B, R]
  const uint8_t* forced_keys;  // [K]
  uint8_t* compat;             // [B, Nrows]
  float* key;                  // [B, Nrows]
  uint32_t* scratch;           // blocks x words, only when the layout spilled
  int B, Nrows, K, Words, C, R;
};

// One block's layout, in 4-byte words: the tested keys in order, the
// forced-key bytes, the tile's labels as copied [tile][K], their codes
// [tile][kp], taint classes [tile], rank keys [tile], allocs [tile][rp],
// then each warp's item buffer (mask words, requests, tolerations as
// bytes); each part 16-byte aligned. kp and rp are odd, so the 32 lanes of
// a warp, on 32 consecutive rows, read 32 different banks.
struct Plan {
  int tile, kp, rp, n_tiles, groups;
  bool spill;
  size_t fk, raw, code, tc, rank, alloc, warp, wmask4, wreq4, wwords, words;
};

static size_t up4(size_t n) { return (n + 3) & ~(size_t)3; }

static Plan plan_of(int B, int Nrows, int K, int Words, int C, int R, int sms) {
  Plan p;
  p.kp = K | 1;
  p.rp = R | 1;
  auto layout = [&](int tile) {
    p.tile = tile;
    p.fk = up4(K);
    p.raw = p.fk + up4((K + 3) / 4);
    p.code = p.raw + up4((size_t)tile * K);
    p.tc = p.code + (size_t)tile * p.kp;
    p.rank = p.tc + tile;
    p.alloc = p.rank + tile;
    p.warp = up4(p.alloc + (size_t)tile * p.rp);
    p.wmask4 = up4((size_t)K * Words);
    p.wreq4 = up4(R);
    p.wwords = p.wmask4 + p.wreq4 + up4((C + 3) / 4);
    p.words = p.warp + NWARP * p.wwords;
    return 4 * p.words;
  };
  // tiles small enough that (item, tile) pairs fill every warp of 2 blocks an SM
  const long long units = 2LL * sms * NWARP;
  long long want = ((long long)Nrows * (B > 0 ? B : 1) + units - 1) / units;
  int tile = (int)((min(want, (long long)TILE_MAX) + 31) / 32) * 32;
  const int cover = ((Nrows + 31) / 32) * 32;
  tile = tile < cover ? tile : cover;
  while (tile > 32 && layout(tile) > SMEM_SOFT) tile = ((tile / 2 + 31) / 32) * 32;
  p.spill = layout(tile) > SMEM_LIMIT;
  p.n_tiles = (Nrows + tile - 1) / tile;
  int groups = (2 * sms + p.n_tiles - 1) / p.n_tiles;
  int need = (B + NWARP - 1) / NWARP;
  p.groups = groups < need ? groups : need;
  if (p.groups < 1) p.groups = 1;
  return p;
}

// Copies into the block's layout: asynchronous (cp.async, in commit
// groups that cp_wait<N> waits for, all but the newest N) into shared
// memory, plain loads and stores into the global scratch.
template <bool SPILL>
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  if (SPILL) {
    *reinterpret_cast<uint32_t*>(dst) = __ldg(reinterpret_cast<const uint32_t*>(src));
  } else {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  }
}

template <bool SPILL>
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  if (SPILL) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  }
}

template <bool SPILL>
__device__ __forceinline__ void cp_commit() {
  if (!SPILL) asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N, bool SPILL>
__device__ __forceinline__ void cp_wait() {
  if (!SPILL) asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool any(const bool (&ok)[RPL]) {
  bool x = false;
#pragma unroll
  for (int u = 0; u < RPL; ++u) x |= ok[u];
  return x;
}

// the elements e0, e0 + step, ... of a [rows][n] row-major array as
// (row, column), stepped without a division per element
struct Walk {
  unsigned rl, k, drl, dk, n;
  __device__ Walk(unsigned e0, unsigned step, unsigned n_) : n(n_) {
    rl = n ? e0 / n : 0;
    k = e0 - rl * n;
    drl = n ? step / n : 0;
    dk = step - drl * n;
  }
  __device__ void next() {
    rl += drl;
    k += dk;
    if (k >= n) {
      k -= n;
      ++rl;
    }
  }
};

// SPILL: the block's layout is its slice of the global scratch instead of
// shared memory (the same code; the flag names the address space)
template <bool SPILL>
__global__ void __launch_bounds__(NT, 2) feasibility_kernel(Args a, Plan p) {
  extern __shared__ __align__(16) uint32_t dyn[];
  __shared__ int s_kn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t* base = SPILL ? a.scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * p.words : dyn;
  int* klist = reinterpret_cast<int*>(base);
  uint8_t* forced = reinterpret_cast<uint8_t*>(base + p.fk);
  int* raw = reinterpret_cast<int*>(base + p.raw);
  int* code = reinterpret_cast<int*>(base + p.code);
  int* tcls = reinterpret_cast<int*>(base + p.tc);
  float* rank = reinterpret_cast<float*>(base + p.rank);
  float* alloc = reinterpret_cast<float*>(base + p.alloc);
  const int K = a.K, Words = a.Words, R = a.R, C = a.C, kp = p.kp, rp = p.rp;
  const int r0 = blockIdx.x * p.tile;
  const int rows = min(p.tile, a.Nrows - r0);

  // the tile's row side, copied once: its labels as they lie (16 bytes a
  // copy where aligned), allocs, taint classes, ranks; warp 0 copies the
  // forced keys
  const int* lab = a.row_labels + (size_t)r0 * K;
  const float* al = a.row_alloc + (size_t)r0 * R;
  const unsigned nl = (unsigned)rows * K, na = (unsigned)rows * R;
  const bool lvec = (nl & 3) == 0 && (reinterpret_cast<uintptr_t>(lab) & 15) == 0;
  const unsigned lw = lvec ? 4 : 1;  // labels a thread copies at once
  for (unsigned e = tid * lw; e < nl; e += NT * lw) {
    if (lvec)
      copy16<SPILL>(raw + e, lab + e);
    else
      copy4<SPILL>(raw + e, lab + e);
  }
  {
    Walk q(tid, NT, R);
    for (unsigned e = tid; e < na; e += NT, q.next()) copy4<SPILL>(alloc + q.rl * rp + q.k, al + e);
  }
  for (int rl = tid; rl < rows; rl += NT) {
    copy4<SPILL>(tcls + rl, a.row_taint_class + r0 + rl);
    copy4<SPILL>(rank + rl, a.row_pool_rank + r0 + rl);
  }
  if (warp == 0) {
    if ((K & 3) == 0 && (reinterpret_cast<uintptr_t>(a.forced_keys) & 3) == 0)
      for (int i = lane; i < K / 4; i += 32) copy4<SPILL>(forced + 4 * i, a.forced_keys + 4 * i);
    else
      for (int i = lane; i < K; i += 32) forced[i] = __ldg(a.forced_keys + i);
  }
  cp_commit<SPILL>();

  // each warp's items w0, w0 + stride, ...: an item's mask words, requests
  // and tolerations are copied into the warp's buffer once, the first
  // item's while the row side is staged
  const size_t mwords = (size_t)K * Words;
  const bool vec = (mwords & 3) == 0 && (reinterpret_cast<uintptr_t>(a.item_mask) & 15) == 0;
  const bool tvec = (C & 3) == 0 && (reinterpret_cast<uintptr_t>(a.taint_ok) & 3) == 0;
  uint32_t* wmask = base + p.warp + (size_t)warp * p.wwords;
  float* wreq = reinterpret_cast<float*>(wmask + p.wmask4);
  uint8_t* wtaint = reinterpret_cast<uint8_t*>(wmask + p.wmask4 + p.wreq4);
  auto copy_item = [&](long long w) {
    const uint32_t* m = a.item_mask + (size_t)w * mwords;
    if (vec)
      for (size_t i = lane; i < mwords / 4; i += 32) copy16<SPILL>(wmask + 4 * i, m + 4 * i);
    else
      for (size_t i = lane; i < mwords; i += 32) copy4<SPILL>(wmask + i, m + i);
    for (int i = lane; i < R; i += 32) copy4<SPILL>(wreq + i, a.item_req + (size_t)w * R + i);
    const uint8_t* t = a.taint_ok + (size_t)w * C;
    if (tvec)
      for (int i = lane; i < C / 4; i += 32) copy4<SPILL>(wtaint + 4 * i, t + 4 * i);
    else
      for (int i = lane; i < C; i += 32) wtaint[i] = __ldg(t + i);
    cp_commit<SPILL>();
  };
  const long long w0 = (long long)blockIdx.y * NWARP + warp, stride = (long long)gridDim.y * NWARP;
  if (w0 < a.B)
    copy_item(w0);
  else
    cp_commit<SPILL>();

  // each thread turns what it copied into its test: a label into its code
  // (-1 for a negative id, which never matches, else the clamped word * 32
  // plus the bit), a taint class into the one the reference's gather reads
  // (a negative one wrapped once, then clamped), a rank into rank * 1e9
  cp_wait<1, SPILL>();
  {
    Walk c(tid * lw, NT * lw - (lw - 1), K);
    for (unsigned e = tid * lw; e < nl; e += NT * lw, c.next()) {
      for (unsigned q = 0; q < lw; ++q) {
        const int idx = raw[e + q];
        code[c.rl * kp + c.k] = idx < 0 ? -1 : (min(idx >> 5, Words - 1) << 5) | (idx & 31);
        if (q + 1 < lw) {
          if (++c.k == c.n) {
            c.k = 0;
            ++c.rl;
          }
        }
      }
    }
  }
  for (int rl = tid; rl < rows; rl += NT) {
    const int tc = tcls[rl];
    tcls[rl] = min(max(tc < 0 ? tc + C : tc, 0), C - 1);
    rank[rl] = __fmul_rn((float)__float_as_int(rank[rl]), 1e9f);
  }
  // meanwhile warp 0 lists the keys that are tested, in order (a forced key always passes)
  if (warp == 0) {
    __syncwarp();
    int n = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const bool tested = k < K && forced[k] == 0;
      const unsigned m = __ballot_sync(FULL, tested);
      if (tested) klist[n + __popc(m & ((1u << lane) - 1))] = k;
      n += __popc(m);
    }
    if (lane == 0) s_kn = n;
  }
  __syncthreads();
  const int kn = s_kn;

  for (long long w = w0; w < a.B; w += stride) {
    if (w != w0) copy_item(w);
    cp_wait<0, SPILL>();
    for (int r = lane; r < R; r += 32) wreq[r] = fmaxf(wreq[r], 1e-6f);
    __syncwarp();
    uint8_t* crow = a.compat + (size_t)w * a.Nrows + r0;
    float* krow = a.key + (size_t)w * a.Nrows + r0;
    // each lane tests RPL rows side by side, rb + lane, rb + 32 + lane, ...
    // (a row past the tile reads the last row and is not written)
    for (int rb = 0; rb < rows; rb += 32 * RPL) {
      int rl[RPL];
      bool ok[RPL];
#pragma unroll
      for (int u = 0; u < RPL; ++u) {
        rl[u] = min(rb + 32 * u + lane, rows - 1);
        ok[u] = rb + 32 * u + lane < rows && wtaint[tcls[rl[u]]] != 0;
      }
      // a row's test is decided by its first false key; the lane's loop
      // ends at the key that leaves none of its rows compatible (the rows'
      // tests run without a branch)
      for (int j = 0; j < kn && any(ok); ++j) {
        const int k = klist[j], kw = k * Words;
#pragma unroll
        for (int u = 0; u < RPL; ++u) {
          const int v = code[rl[u] * kp + k];
          const uint32_t mw = wmask[kw + (max(v, 0) >> 5)];
          ok[u] = ok[u] & (v >= 0) & (((mw >> (v & 31)) & 1u) != 0);
        }
      }
      const int nu = min(RPL, (rows - rb + 31) / 32);
      for (int u = 0; u < nu; ++u) {
        float score = 0.f;
        for (int r = 0; r < R; ++r) {
          const float q = __fdiv_rn(alloc[rl[u] * rp + r], wreq[r]);
          score = r == 0 ? q : fminf(score, q);
        }
        if (rb + 32 * u + lane < rows) {
          crow[rl[u]] = ok[u] ? 1 : 0;
          krow[rl[u]] = __fsub_rn(rank[rl[u]], fminf(score, 1e8f));
        }
      }
    }
    __syncwarp();  // the buffer is refilled for the warp's next item
  }
}

static int sm_count(int* sms) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// int32 words of global scratch a call needs (0 when its layout fits in shared memory)
extern "C" long long kt_feasibility_scratch(int B, int Nrows, int K, int Words, int C, int R) {
  int sms;
  if (sm_count(&sms) != 0) return -1;
  const Plan p = plan_of(B, Nrows, K, Words, C, R, sms);
  return p.spill ? (long long)p.n_tiles * p.groups * (long long)p.words : 0;
}

extern "C" int kt_feasibility(const void* row_labels, const void* row_taint_class, const void* row_alloc,
                              const void* row_pool_rank, const void* item_mask, const void* taint_ok,
                              const void* item_req, const void* forced_keys, int B, int Nrows, int K, int Words,
                              int C, int R, void* compat, void* key, void* scratch, void* stream) {
  int sms;
  int e = sm_count(&sms);
  if (e != 0) return e;
  if (B <= 0 || Nrows <= 0) return 0;
  const Plan p = plan_of(B, Nrows, K, Words, C, R, sms);
  if (p.spill && scratch == nullptr) return (int)cudaErrorInvalidValue;
  Args a{(const int*)row_labels, (const int*)row_taint_class, (const float*)row_alloc, (const int*)row_pool_rank,
         (const uint32_t*)item_mask, (const uint8_t*)taint_ok, (const float*)item_req, (const uint8_t*)forced_keys,
         (uint8_t*)compat, (float*)key, (uint32_t*)scratch, B, Nrows, K, Words, C, R};
  const dim3 grid(p.n_tiles, p.groups);
  if (p.spill) {
    feasibility_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(a, p);
    return (int)cudaGetLastError();
  }
  const int smem = (int)(4 * p.words);
  if (smem > 48 * 1024) {
    cudaError_t s = cudaFuncSetAttribute(feasibility_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (s != cudaSuccess) return (int)s;
  }
  feasibility_kernel<false><<<grid, NT, smem, (cudaStream_t)stream>>>(a, p);
  return (int)cudaGetLastError();
}

// an empty kernel: the floor of any launch, for timing beside K1
__global__ void empty_kernel() {}

extern "C" int kt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
