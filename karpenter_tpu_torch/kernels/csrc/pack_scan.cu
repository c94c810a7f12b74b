// K2 pack_scan: the signature-grouped FFD pack scan, one persistent block
// (with helper blocks that build the item data first).
//
// The code is in `pack_scan_common.cuh`, shared with K2's slot-sharded form
// (`pack_scan_sharded.cu`); this file instantiates it with the single-block
// policy `BlockExchange` and holds K2's entry points.
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
// - Every axis is sized from the problem. Domain, restricted-key, host-port
//   and rank sets are bit sets of nw 32-bit words, nw = ceil(max(D, Kd, P1,
//   P2, Q) / 32); the kernel is built from the same code with nw fixed at
//   1 (the common case, in registers) and with nw read, and with its
//   tables in shared memory or in a global spill.
//   Per-item group lists, per-resource arrays and the thread-0 scratch are
//   sized from G, R and D.
// - The state of the first `tile` slots (basis, rank, remaining capacity,
//   domain and port sets, the call's take) lives in shared memory for the
//   whole scan, loaded once and written back once; slots past the tile keep
//   theirs in global memory (the carry buffers and a scratch of masks),
//   behind the same accessors. Rows likewise: the first `rt` rows' data in
//   shared memory, the rest read from global memory. The constants, the
//   exchange totals and the item buffers take shared memory first; what
//   does not fit goes to a global spill behind the same pointers (see
//   Layout), and the tiles shrink to the room left. Slot j is always handled
//   by thread j % NT, so a slot's state needs no barrier between phases.
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

#include "pack_scan_common.cuh"

template <int NW, bool FITS>
__global__ void __launch_bounds__(NT, 1) pack_scan_kernel(PackArgs a) {
  pack_scan_body<NW, FITS, BlockExchange>(a, 1);
}

// ptrs: the PackArgs pointers in declaration order; dims: W, N, Nrows, R, D,
// G, Q, Kd, P1, P2, HB, n_existing, n_rows_real
extern "C" int kt_pack_scan(const long long* ptrs, const int* dims, void* stream) {
  PackArgs a;
  fill_args(a, ptrs, dims);
  const Layout L = layout_of_args<BlockExchange>(a, 1);
  // one word per bit set with the tables in shared memory (the common case)
  // has its own build of the same code
  const void* kern = !L.fits    ? (const void*)pack_scan_kernel<0, false>
                     : a.nw == 1 ? (const void*)pack_scan_kernel<1, true>
                                 : (const void*)pack_scan_kernel<0, true>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (e != cudaSuccess) return (int)e;
  // block 0 scans; the item blocks (one item per warp up to MAX_ITEM_BLOCKS
  // blocks, all co-resident) build the item data first
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, L.bytes)) != cudaSuccess) return (int)e;
  int item_blocks = (a.W + NWARP - 1) / NWARP;
  item_blocks = min(max(item_blocks, 1), min(MAX_ITEM_BLOCKS, per_sm * sms - 1));
  if (item_blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kern, dim3(1 + item_blocks), dim3(NT), args, L.bytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// int32 words of scratch the kernel needs (same dims as kt_pack_scan)
extern "C" long long kt_pack_scan_scratch(const int* dims) {
  PackArgs a;
  const long long none[38] = {0};
  fill_args(a, none, dims);
  return (long long)scratch_of(layout_of_args<BlockExchange>(a, 1), a.W, a.N, a.Nrows, a.Q, a.D, 1).words;
}
