// K2's slot-sharded form: the grouped pack scan with the slot axis split into
// S shards, one scan block per shard, in one cooperative launch.
//
// Replaces: karpenter_tpu/parallel/sharded.py `_sharded_pack_state_fn`
// (:177), the shard_map'd `_pack_body(axis="batch")` (models/
// scheduler_model_grouped.py :450-512: `gprefix`, `gsum`, `gany_slots` over
// the mesh) that `greedy_pack_grouped_sharded_state` (:264) runs.
//
// Design: the code of K2 (`pack_scan_common.cuh`) under a sharded policy.
// Blocks 0..S-1 are the shards: shard s owns slots [s N/S, (s + 1) N/S),
// keeps their state in its own shared memory behind K2's accessors (the
// first `tile` of them) and scans every item; the other blocks build the
// items' data first, as in K2. Everything but the slot axis is replicated:
// each shard block holds the constants, the row tile and the item buffers,
// and its own copy of counts_zone and open_count, and makes every decision
// that reads only them (the best row, the fresh-slot count, the water-fills)
// itself, the same in every shard. The slot-axis reductions of a `place()`
// call and of the zone and affinity branches are exchanges among the shard
// blocks through global memory:
// - `gprefix`: each shard's capacity total and largest capacity; a shard's
//   prefix starts at the earlier shards' total (int32 wraparound in
//   unsigned arithmetic, as the reference's int32 sums);
// - `gsum`: each shard's take total, where K2's closed form does not hold;
// - `gany`: the OR over the shards of nw domain words.
// An exchange: warp 0 of each shard writes its part into buffer e & 1 of
// the scratch (a fast shard writes exchange e + 2's part only after every
// shard has passed exchange e + 1, so after every shard read exchange e's),
// arrives at the shard blocks' barrier (a counter every shard adds one to
// with release order at device scope; exchange e ends when it reaches
// (e + 1) S, read with acquire order), reads all S parts from L2 (lane l
// the parts of shards l, l + 32, ..., so any S) and reduces them (the
// prefix over the shards before this one; the int32 sums wrap, so their
// order does not change them); a block barrier hands the result to the
// block. The wait is bounded and traps (~2^34 cycles), as K2's does. A shard
// whose slots are all past the open count still joins every exchange with
// zeros: every branch reaches the same exchanges in every shard. The
// cooperative launch keeps every shard block resident at once.
//
// What bounds it on an H100: as K2, the sequential chain of items, now with
// the exchanges' round trips through L2 on it (~3 per place() call). On one
// card the shards are virtual: this form carries the multi-card layout and
// proves its exchange; it is not faster than K2.

#include <cuda/atomic>

#include "pack_scan_common.cuh"

// the bounded wait of an exchange (cycles) before the kernel traps
#define XWAIT_CYCLES (1LL << 34)

struct GridExchange {
  static constexpr bool kSharded = true;
  // the shard block's exchange count and the reduced values (static shared)
  struct Shared {
    unsigned ep;
    unsigned v[4];
  };
  static constexpr int kStaticExtra = sizeof(Shared);

  static __device__ __forceinline__ Shared& shared() {
    __shared__ Shared g;
    return g;
  }

  template <class C>
  static __device__ __forceinline__ uint32_t* part(const C& k, unsigned e, int shard) {
    return k.xparts + ((size_t)(e & 1u) * k.nshard + shard) * k.xw;
  }

  // warp 0, after its lanes wrote exchange e's part: arrive, wait for every
  // shard (bounded), count the exchange
  template <class C>
  static __device__ __forceinline__ void arrive_wait(const C& k, unsigned e) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      __threadfence();
      cuda::atomic_ref<unsigned, cuda::thread_scope_device> bar(*k.xbar);
      bar.fetch_add(1u, cuda::memory_order_release);
      const unsigned target = (e + 1u) * (unsigned)k.nshard;
      const long long t0 = clock64();
      while (bar.load(cuda::memory_order_acquire) < target)
        if (clock64() - t0 > XWAIT_CYCLES) __trap();
      __threadfence();
      shared().ep = e + 1u;
    }
    __syncwarp();
  }

  // gprefix: `run` becomes the earlier shards' capacity total, `total` the
  // whole axis' and `mx` the largest capacity over it. tot: the block's
  // per-warp chunk totals (nch chunks).
  template <class C>
  static __device__ __forceinline__ void gprefix(const C& k, const unsigned* tot, int nch, unsigned& run,
                                                 unsigned& total, unsigned& mx) {
    Shared& g = shared();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const unsigned e = g.ep;
      unsigned t = 0;
      for (int x = lane; x < nch * NWARP; x += 32) t += tot[x];
      t = __reduce_add_sync(FULL, t);
      if (lane == 0) {
        uint32_t* p = part(k, e, k.shard);
        __stcg(p, t);
        __stcg(p + 1, mx);
      }
      arrive_wait(k, e);
      // lane l reads shards l, l + 32, ...: its sums of the earlier shards'
      // totals and of all of them, and its largest capacity
      unsigned lo = 0, ts = 0, ms = 0;
      for (int sh = lane; sh < k.nshard; sh += 32) {
        const uint32_t* p = part(k, e, sh);
        const unsigned t_sh = __ldcg(p);
        if (sh < k.shard) lo += t_sh;
        ts += t_sh;
        ms = max(ms, __ldcg(p + 1));
      }
      const unsigned off = __reduce_add_sync(FULL, lo);
      const unsigned all = __reduce_add_sync(FULL, ts);
      const unsigned gm = __reduce_max_sync(FULL, ms);
      if (lane == 0) {
        g.v[0] = off;
        g.v[1] = all;
        g.v[2] = gm;
      }
    }
    __syncthreads();
    run = g.v[0];
    total = g.v[1];
    mx = g.v[2];
  }

  // gsum: the block's sum (the same in every thread) -> the axis' sum
  template <class C>
  static __device__ __forceinline__ unsigned gsum(const C& k, unsigned block_sum) {
    Shared& g = shared();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const unsigned e = g.ep;
      if (lane == 0) __stcg(part(k, e, k.shard), block_sum);
      arrive_wait(k, e);
      unsigned v = 0;
      for (int sh = lane; sh < k.nshard; sh += 32) v += __ldcg(part(k, e, sh));
      const unsigned all = __reduce_add_sync(FULL, v);
      if (lane == 0) g.v[3] = all;
    }
    __syncthreads();
    return g.v[3];
  }

  // gany: the OR over the shards of the block's OR words in exchange buffer
  // b (K2's per-warp buffers); the result is ORed into warp 0's words of b,
  // so `gany_word(k, b, w)` reads the axis' OR
  template <class C>
  static __device__ __forceinline__ void gany(const C& k, int b) {
    Shared& g = shared();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const unsigned e = g.ep;
      const int nw = k.nw();
      uint32_t* mine = part(k, e, k.shard);
      for (int w = lane; w < nw; w += 32) __stcg(mine + w, gany_word(k, b, w));
      arrive_wait(k, e);
      for (int w = lane; w < nw; w += 32) {
        uint32_t acc = 0;
        for (int sh = 0; sh < k.nshard; ++sh) acc |= __ldcg(part(k, e, sh) + w);
        gany_buf(k, b, 0)[w] |= acc;
      }
    }
    __syncthreads();
  }
};

template <int NW, bool FITS>
__global__ void __launch_bounds__(NT, 1) pack_scan_sharded_kernel(PackArgs a, int nshard) {
  if (threadIdx.x == 0) GridExchange::shared().ep = 0;
  // (the body's first barrier orders this before any exchange)
  pack_scan_body<NW, FITS, GridExchange>(a, nshard);
}

// ptrs: as kt_pack_scan's, with counts_zone [S, G, D] and open_count [S] (one
// copy per shard); dims: kt_pack_scan's, then S. Returns
// cudaErrorCooperativeLaunchTooLarge when the S shard blocks and one item
// block cannot all be resident.
extern "C" int kt_pack_scan_sharded(const long long* ptrs, const int* dims, void* stream) {
  PackArgs a;
  fill_args(a, ptrs, dims);
  const int S = dims[13];
  if (S < 1 || a.N % S != 0) return (int)cudaErrorInvalidValue;
  const Layout L = layout_of_args(a, S, GridExchange::kStaticExtra);
  const void* kern = !L.fits    ? (const void*)pack_scan_sharded_kernel<0, false>
                     : a.nw == 1 ? (const void*)pack_scan_sharded_kernel<1, true>
                                 : (const void*)pack_scan_sharded_kernel<0, true>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, L.bytes)) != cudaSuccess) return (int)e;
  int item_blocks = (a.W + NWARP - 1) / NWARP;
  item_blocks = min(max(item_blocks, 1), min(MAX_ITEM_BLOCKS, per_sm * sms - S));
  if (item_blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int nshard = S;
  void* args[] = {&a, &nshard};
  e = cudaLaunchCooperativeKernel(kern, dim3(S + item_blocks), dim3(NT), args, L.bytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// int32 words of scratch the sharded kernel needs (same dims as kt_pack_scan_sharded)
extern "C" long long kt_pack_scan_sharded_scratch(const int* dims) {
  PackArgs a;
  const long long none[38] = {0};
  fill_args(a, none, dims);
  const int S = dims[13];
  if (S < 1 || a.N % S != 0) return 0;
  return (long long)scratch_of(layout_of_args(a, S, GridExchange::kStaticExtra), a.W, a.N, a.Nrows, a.Q, a.D, S)
      .words;
}
