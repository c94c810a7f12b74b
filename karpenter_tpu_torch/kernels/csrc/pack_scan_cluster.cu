// K2's slot-sharded form, the cluster form: the shards as the CTAs of one
// thread-block cluster, exchanging through distributed shared memory.
//
// Replaces: karpenter_tpu/parallel/sharded.py `_sharded_pack_state_fn`
// (:177), as the grid form in `pack_scan_sharded.cu` does; its header holds
// the design of both forms and what the card showed. A source of its own,
// so that its nvcc runs beside the grid form's.

#include "pack_scan_common.cuh"

// the address in shard `rank`'s shared memory of `p`, an address in this
// block's (the same offset: every shard has the same layout)
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  const uint32_t mine = (uint32_t)__cvta_generic_to_shared(p);
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(mine), "r"(rank));
  return r;
}

__device__ __forceinline__ uint32_t ld_peer(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// every thread of every shard: what each wrote before is visible to every
// shard after
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

struct ClusterExchange {
  static constexpr bool kSharded = true;
  using Shared = XShared;
  static constexpr int kStaticExtra = sizeof(Shared);
  // two buffers of this shard's part, in its own shared memory
  static __host__ __device__ __forceinline__ int x_words(int nw, int) { return 2 * xw_of(nw); }

  static __device__ __forceinline__ Shared& shared() {
    __shared__ Shared g;
    return g;
  }

  template <class C>
  static __device__ __forceinline__ uint32_t* part(const C& k, unsigned e) {
    return k.xparts + (size_t)(e & 1u) * k.xw;
  }

  // the item blocks are a launch of their own just before, which lets this
  // one start early: wait until it has finished and its writes are visible
  template <class C>
  static __device__ __forceinline__ void wait_items(const C&) { asm volatile("griddepcontrol.wait;" ::: "memory"); }

  // count this shard's exchanges; no shard exits while a peer may still
  // read its parts
  template <class C>
  static __device__ __forceinline__ void finish(const C& k) {
    if (threadIdx.x == 0) atomicAdd(k.xbar, shared().ep);
    cluster_barrier();
  }

  // gprefix, as GridExchange's
  template <class C>
  static __device__ __forceinline__ void gprefix(const C& k, const unsigned* tot, int nch, unsigned& run,
                                                 unsigned& total, unsigned& mx) {
    Shared& g = shared();
    const int lane = threadIdx.x & 31;
    const unsigned e = g.ep;
    if (threadIdx.x < 32) {
      unsigned t = 0;
      for (int x = lane; x < nch * NWARP; x += 32) t += tot[x];
      t = __reduce_add_sync(FULL, t);
      if (lane == 0) {
        uint32_t* p = part(k, e);
        p[0] = t;
        p[1] = mx;
      }
    }
    cluster_barrier();
    if (threadIdx.x < 32) {
      unsigned lo = 0, ts = 0, ms = 0;
      for (int sh = lane; sh < k.nshard; sh += 32) {
        const uint32_t p = peer_addr(part(k, e), sh);
        const unsigned t_sh = ld_peer(p);
        if (sh < k.shard) lo += t_sh;
        ts += t_sh;
        ms = max(ms, ld_peer(p + 4));
      }
      const unsigned off = __reduce_add_sync(FULL, lo);
      const unsigned all = __reduce_add_sync(FULL, ts);
      const unsigned gm = __reduce_max_sync(FULL, ms);
      if (lane == 0) {
        g.v[0] = off;
        g.v[1] = all;
        g.v[2] = gm;
        g.ep = e + 1u;
      }
    }
    __syncthreads();
    run = g.v[0];
    total = g.v[1];
    mx = g.v[2];
  }

  // gsum, as GridExchange's
  template <class C>
  static __device__ __forceinline__ unsigned gsum(const C& k, unsigned block_sum) {
    Shared& g = shared();
    const int lane = threadIdx.x & 31;
    const unsigned e = g.ep;
    if (threadIdx.x == 0) part(k, e)[0] = block_sum;
    cluster_barrier();
    if (threadIdx.x < 32) {
      unsigned v = 0;
      for (int sh = lane; sh < k.nshard; sh += 32) v += ld_peer(peer_addr(part(k, e), sh));
      const unsigned all = __reduce_add_sync(FULL, v);
      if (lane == 0) {
        g.v[3] = all;
        g.ep = e + 1u;
      }
    }
    __syncthreads();
    return g.v[3];
  }

  // gany, as GridExchange's: the axis' OR is ORed into warp 0's words of b
  template <class C>
  static __device__ __forceinline__ void gany(const C& k, int b) {
    Shared& g = shared();
    const int lane = threadIdx.x & 31;
    const unsigned e = g.ep;
    const int nw = k.nw();
    uint32_t* mine = part(k, e);
    if (threadIdx.x < 32)
      for (int w = lane; w < nw; w += 32) mine[w] = gany_word(k, b, w);
    cluster_barrier();
    if (threadIdx.x < 32) {
      for (int w = lane; w < nw; w += 32) {
        uint32_t acc = 0;
        for (int sh = 0; sh < k.nshard; ++sh) acc |= ld_peer(peer_addr(mine + w, sh));
        gany_buf(k, b, 0)[w] |= acc;
      }
      if (lane == 0) g.ep = e + 1u;
    }
    __syncthreads();
  }
};

// -- kernel and entry points ------------------------------------------------------------

// launched twice per scan: the item blocks (first = nshard, any grid), then
// the cluster of the nshard shard blocks (first = 0)
template <int NW, bool FITS>
__global__ void __launch_bounds__(NT, 1) pack_scan_cluster_kernel(PackArgs a, int nshard, int first) {
  if (first > 0) asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (threadIdx.x == 0) ClusterExchange::shared().ep = 0;
  pack_scan_body<NW, FITS, ClusterExchange>(a, nshard, first);
}
// the largest cluster `kt_pack_scan_cluster_max` tries (the hardware's,
// non-portable past 8)
#define MAX_CLUSTER 16

// the build for layout L (one word per bit set with the tables in shared
// memory, the common case, has its own)
static const void* cluster_kernel(const Layout& L, int nw) {
  return !L.fits  ? (const void*)pack_scan_cluster_kernel<0, false>
         : nw == 1 ? (const void*)pack_scan_cluster_kernel<1, true>
                   : (const void*)pack_scan_cluster_kernel<0, true>;
}

static cudaError_t allow_cluster(const void* kern, const Layout& L) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

static cudaLaunchAttribute cluster_dims(int c) {
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = (unsigned)c;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  return at;
}

// The cluster form: same ptrs and dims as kt_pack_scan_sharded. Two launches
// on `stream`: the item blocks, then one cluster of S shard blocks (a
// programmatic dependent launch). A cluster the card cannot place is the
// launch's own error.
extern "C" int kt_pack_scan_cluster(const long long* ptrs, const int* dims, void* stream) {
  PackArgs a;
  fill_args(a, ptrs, dims);
  const int S = dims[13];
  if (S < 1 || S > MAX_CLUSTER || a.N % S != 0) return (int)cudaErrorInvalidValue;
  const Layout L = layout_of_args<ClusterExchange>(a, S);
  const void* kern = cluster_kernel(L, a.nw);
  cudaError_t e = allow_cluster(kern, L);
  if (e != cudaSuccess) return (int)e;
  int nshard = S, first = S, first0 = 0;
  const int item_blocks = min(max((a.W + NWARP - 1) / NWARP, 1), MAX_ITEM_BLOCKS);
  void* items_args[] = {&a, &nshard, &first};
  e = cudaLaunchKernel(kern, dim3(item_blocks), dim3(NT), items_args, L.bytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute at[2];
  at[0] = cluster_dims(S);
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  void* scan_args[] = {&a, &nshard, &first0};
  e = cudaLaunchKernelExC(&cfg, kern, scan_args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// int32 words of scratch the cluster form needs (same dims)
extern "C" long long kt_pack_scan_cluster_scratch(const int* dims) {
  PackArgs a;
  const long long none[38] = {0};
  fill_args(a, none, dims);
  const int S = dims[13];
  if (S < 1 || a.N % S != 0) return 0;
  return (long long)scratch_of(layout_of_args<ClusterExchange>(a, S), a.W, a.N, a.Nrows, a.Q, a.D, S).words;
}

// The largest cluster of shard blocks (at most MAX_CLUSTER) that the card
// places at the cluster form's shared memory for these dims (S = dims[13]
// sets the slot tile): the first size from MAX_CLUSTER down with
// cudaOccupancyMaxActiveClusters >= 1. 0 when none does; -(error) when a
// query of a portable size (8 or less) fails. A non-portable size the card
// refuses does not place.
extern "C" int kt_pack_scan_cluster_max(const int* dims) {
  PackArgs a;
  const long long none[38] = {0};
  fill_args(a, none, dims);
  const int S = dims[13];
  if (S < 1 || a.N % S != 0) return -(int)cudaErrorInvalidValue;
  const Layout L = layout_of_args<ClusterExchange>(a, S);
  const void* kern = cluster_kernel(L, a.nw);
  cudaError_t e = allow_cluster(kern, L);
  if (e != cudaSuccess) return -(int)e;
  for (int c = MAX_CLUSTER; c >= 1; --c) {
    cudaLaunchAttribute at = cluster_dims(c);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = L.bytes;
    cfg.attrs = &at;
    cfg.numAttrs = 1;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (e != cudaSuccess) {
      (void)cudaGetLastError();  // not sticky: clear it before the next call reads it
      if (c <= 8) return -(int)e;
      continue;
    }
    if (n >= 1) return c;
  }
  return 0;
}
