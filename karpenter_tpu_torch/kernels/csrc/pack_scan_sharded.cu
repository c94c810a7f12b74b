// K2's slot-sharded form: the grouped pack scan with the slot axis split into
// S shards, one scan block per shard, in one of two forms that share K2's
// code and differ only in how the shards exchange.
//
// Replaces: karpenter_tpu/parallel/sharded.py `_sharded_pack_state_fn`
// (:177), the shard_map'd `_pack_body(axis="batch")` (models/
// scheduler_model_grouped.py :450-512: `gprefix`, `gsum`, `gany_slots` over
// the mesh) that `greedy_pack_grouped_sharded_state` (:264) runs.
//
// Design: the code of K2 (`pack_scan_common.cuh`) under a sharded policy.
// Scan block s is shard s: it owns slots [s N/S, (s + 1) N/S), keeps their
// state in its own shared memory behind K2's accessors (the first `tile` of
// them; `layout_of` sizes the tile from N/S, so a shard's slot tile shrinks
// with S, while the row tile and the item buffers do not) and scans every
// item; item blocks build the items' data first, as in K2. Everything but
// the slot axis is replicated: each shard block holds the constants, the row
// tile and the item buffers, and its own copy of counts_zone and open_count,
// and makes every decision that reads only them (the best row, the
// fresh-slot count, the water-fills) itself, the same in every shard. The
// slot-axis reductions of a `place()` call and of the zone and affinity
// branches are exchanges among the shards:
// - `gprefix`: each shard's capacity total and largest capacity; a shard's
//   prefix starts at the earlier shards' total (int32 wraparound in
//   unsigned arithmetic, as the reference's int32 sums);
// - `gsum`: each shard's take total, where K2's closed form does not hold;
// - `gany`: the OR over the shards of nw domain words.
// In both forms an exchange is: warp 0 of each shard writes its part into
// buffer e & 1 (a fast shard writes exchange e + 2's part only after every
// shard has passed exchange e + 1, so after every shard read exchange e's),
// the shards synchronise with release / acquire order, warp 0 reads all S
// parts (lane l the parts of shards l, l + 32, ..., so any S) and reduces
// them (the prefix over the shards before this one; the int32 sums wrap, so
// their order does not change them), and a block barrier hands the result to
// the block. A shard whose slots are all past the open count still joins
// every exchange with zeros: every branch reaches the same exchanges in
// every shard. Each shard counts its exchanges into scratch word 1, which
// the wrapper returns (S per exchange in both forms).
//
// `ClusterExchange` (`kt_pack_scan_cluster`, in `pack_scan_cluster.cu`: a
// source of its own, so that the two forms' nvcc processes run side by side;
// one file with both was the build's longest by far): the S shard blocks are
// the CTAs of one thread-block cluster (CTA rank s is shard s). The parts live
// in each shard's own shared memory (the layout's `xpart` region, two
// buffers); the shards synchronise with the cluster barrier
// (`barrier.cluster.arrive.release` / `barrier.cluster.wait.acquire`, every
// thread of every shard) and warp 0 reads the peers' parts through distributed
// shared memory (`mapa` + `ld.shared::cluster`). The cluster barrier and not a
// per-shard mbarrier: every thread of the block reaches each exchange anyway
// and a block barrier follows it, so letting every thread take part costs the
// block little, and the hardware barrier replaces the L2 counter, its spin and
// its fences outright. It cannot time out (the grid form's wait traps): a
// divergence between the shards' exchange sequences would hang instead; no
// input has shown one in the grid form. A cluster only guarantees that its own
// CTAs are co-scheduled, so the item blocks are a launch of their own just
// before, on the same stream (the same kernel, its blocks taking logical
// indices S..), and the cluster launch is a programmatic dependent launch: the
// item blocks let it start at once (`griddepcontrol.launch_dependents`), it
// loads its constants and slot tile meanwhile and waits for them to finish
// (`griddepcontrol.wait`) before it reads an item; it never spins on a block
// whose residency nothing guarantees. After its last exchange each shard
// passes one more cluster barrier, so no CTA exits while a peer may still read
// its shared memory. A shard block takes up to SMEM_LIMIT and one block per SM
// (`__launch_bounds__(NT, 1)`), so a cluster of S needs S SMs of one GPC:
// `kt_pack_scan_cluster_max` asks `cudaOccupancyMaxActiveClusters` for the
// largest size up to 16 (past 8 with
// `cudaFuncAttributeNonPortableClusterSizeAllowed`) that places at the
// launch's shared memory, and the wrapper takes this form where S is at most
// that (`kernels/pack_scan.exchange_form`).
//
// `GridExchange` (`kt_pack_scan_sharded`), any S: one cooperative launch,
// blocks 0..S-1 the shards and the rest the item blocks (the launch keeps
// them all resident). The parts go through global memory (L2); the shards
// synchronise on a counter every shard adds one to with release order at
// device scope (exchange e ends when it reaches (e + 1) S, read with acquire
// order); the wait is bounded and traps (~2^34 cycles), as K2's does. It is
// the form past the largest cluster (33 and 64 shards) and the template for
// an exchange across cards.
//
// What bounds it on an H100: as K2, the sequential chain of items, with the
// exchanges on it (~1 per place() call): a round trip through L2 and a spin
// each in the grid form, a cluster barrier and a distributed-shared-memory
// load each in the cluster form. On one card the shards are virtual; the
// slot loops of a shard run over N/S slots.
//
// What the card showed (H100 80GB HBM3, 700 W):
// - Placement: `cudaOccupancyMaxActiveClusters` places 16 shard blocks
//   (the non-portable maximum) at the headline's shape for every S from 1
//   to 33, 3 and 5 among them: a shard block's shared memory never
//   stopped a cluster; one block per SM (222-255 registers a thread).
// - Co-residency: the item blocks' own launch with the cluster launch as
//   its programmatic dependent; a cooperative launch with cluster
//   dimensions was not tried.
// - Parity: both forms equal K2 and the plain multi-shard arm bit for bit
//   and count the same exchanges (680 at the headline).
// - Time: at the headline (45 open slots, so a shard's slot loops shrink
//   nothing) an exchange costs ~1.1 us beyond K2 in the cluster form and
//   ~2.4 us in the grid form, and neither beats K2; with 1201 / 3801 open
//   slots the split shortens every slot loop and the cluster form beats K2
//   (PERF.md §6 row 12).
// - The other exchange tried: each shard's warp 0 pushing its part into
//   every shard's inbox (`st.async` completing bytes on the receiver's
//   mbarrier) and waiting on its own mbarrier, so that every read is local.
//   Bit-equal too, but no faster beyond the run-to-run spread, so the
//   simpler barrier stays.

#include <cuda/atomic>

#include "pack_scan_common.cuh"

// the bounded wait of an exchange (cycles) before the kernel traps
#define XWAIT_CYCLES (1LL << 34)

struct GridExchange {
  static constexpr bool kSharded = true;
  using Shared = XShared;
  static constexpr int kStaticExtra = sizeof(Shared);
  // the parts are in the global scratch
  static __host__ __device__ __forceinline__ int x_words(int, int) { return 0; }
  // the item blocks are in the same launch: the scan waits on their count
  template <class C>
  static __device__ __forceinline__ void wait_items(const C&) {}
  // the barrier counter counted every arrival
  template <class C>
  static __device__ __forceinline__ void finish(const C&) {}

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

// -- kernel and entry points ------------------------------------------------------------

template <int NW, bool FITS>
__global__ void __launch_bounds__(NT, 1) pack_scan_sharded_kernel(PackArgs a, int nshard) {
  if (threadIdx.x == 0) GridExchange::shared().ep = 0;
  // (the body's first barrier orders this before any exchange)
  pack_scan_body<NW, FITS, GridExchange>(a, nshard);
}

// the build for layout L (one word per bit set with the tables in shared
// memory, the common case, has its own)
static const void* sharded_kernel(const Layout& L, int nw) {
  return !L.fits  ? (const void*)pack_scan_sharded_kernel<0, false>
         : nw == 1 ? (const void*)pack_scan_sharded_kernel<1, true>
                   : (const void*)pack_scan_sharded_kernel<0, true>;
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
  const Layout L = layout_of_args<GridExchange>(a, S);
  const void* kern = sharded_kernel(L, a.nw);
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

// int32 words of scratch the grid form needs (same dims as kt_pack_scan_sharded)
extern "C" long long kt_pack_scan_sharded_scratch(const int* dims) {
  PackArgs a;
  const long long none[38] = {0};
  fill_args(a, none, dims);
  const int S = dims[13];
  if (S < 1 || a.N % S != 0) return 0;
  return (long long)scratch_of(layout_of_args<GridExchange>(a, S), a.W, a.N, a.Nrows, a.Q, a.D, S).words;
}
