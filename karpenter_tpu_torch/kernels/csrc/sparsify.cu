// K3 sparsify: row-major ordered compaction of the [W, N] take matrix into
// -1-padded (item, slot, count) triples, written into the pack's single
// flat int32 output together with basis, zoneset, leftovers and open count.
//
// Replaces: karpenter_tpu/models/scheduler_model_grouped.py
// `_sparsify_takes` (:1002, jnp.nonzero(size=nnz_cap)) and `_flat_outputs`
// (:1012).
//
// What bounds it on an H100: bytes. The take matrix (10.5 MB at the
// headline shape) must be read; the output is ~0.2 MB. ~3 us at 3.35 TB/s.
// At the delta path's small take matrices (W = 176) the launch is the cost.
//
// Design: one launch, one block per item row, rows taken in order by
// a ticket (an atomic counter), so a block only ever waits on blocks that
// started before it. A block copies its row into shared memory once,
// counting its nonzeros, publishes the count, and finds the row-major offset
// by a decoupled look-back: warp 0 reads the status words of the 32 rows
// before it at a time and adds their counts back to the nearest row that
// has published its inclusive prefix. Meanwhile the other warps write the
// block's slice of the tail (basis, zoneset, leftovers, open count). Then
// the block compacts its row from shared memory in slot order (16
// consecutive slots a thread, a block scan of the thread counts) and
// writes its triples; entries past nnz_cap are dropped, as the reference's
// fixed-size nonzero drops them. The block of the last row writes the -1/0
// padding past the total. Status words carry the launch's epoch, so the
// scratch needs no clearing between calls: the last block to finish resets
// the ticket and advances the epoch.

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define PER 16               // consecutive slots per thread in the compaction
#define TILE (NT * PER)
#define ROW_CAP (24 * 1024)  // row entries kept in shared memory (96 KB); the rest is read again
#define FULL 0xffffffffu

// scratch words: [0] ticket, [1] blocks finished, [2] epoch, [3] unused, then one status word per row:
// (tag << 32) | value, tag 2 epoch + 1 for the row's count, 2 epoch + 2 for its inclusive prefix
__global__ void __launch_bounds__(NT)
sparsify_kernel(const int* __restrict__ takes, int W, int N, int D, int nnz_cap, const int* __restrict__ leftovers,
                const int* __restrict__ slot_basis, const uint8_t* __restrict__ slot_zoneset,
                const int* __restrict__ open_count, unsigned long long* __restrict__ st, int* __restrict__ flat,
                int cap) {
  extern __shared__ __align__(16) int row_s[];
  typedef cub::BlockScan<int, NT> Scan;
  typedef cub::BlockReduce<int, NT> Red;
  __shared__ union {
    typename Scan::TempStorage scan;
    typename Red::TempStorage red;
  } temp;
  __shared__ int sh_row, sh_total, sh_excl;
  __shared__ unsigned sh_epoch;
  const int tid = threadIdx.x, lane = tid & 31;
  volatile unsigned long long* vst = st;
  if (tid == 0) {
    sh_epoch = (unsigned)vst[2];
    sh_row = (int)atomicAdd(&st[0], 1ull);
  }
  __syncthreads();
  const int w = sh_row;
  const unsigned long long tag_a = (unsigned long long)(2u * sh_epoch + 1u) << 32;
  const unsigned long long tag_p = (unsigned long long)(2u * sh_epoch + 2u) << 32;
  volatile unsigned long long* status = vst + 4;
  int total = 0, excl = 0;
  const int* row = takes + (size_t)(w < W ? w : 0) * N;
  if (w < W) {
    // the row into shared memory, counting its nonzeros
    int cnt = 0;
    if ((N & 3) == 0) {
      for (int k = tid; k < N / 4; k += NT) {
        const int4 v = reinterpret_cast<const int4*>(row)[k];
        cnt += (v.x != 0) + (v.y != 0) + (v.z != 0) + (v.w != 0);
        if (4 * k < cap) reinterpret_cast<int4*>(row_s)[k] = v;
      }
    } else {
      for (int k = tid; k < N; k += NT) {
        const int v = row[k];
        cnt += v != 0;
        if (k < cap) row_s[k] = v;
      }
    }
    total = Red(temp.red).Sum(cnt);
    if (tid == 0) {
      status[w] = (w == 0 ? tag_p : tag_a) | (unsigned)total;
      sh_total = total;
    }
    __syncthreads();
    total = sh_total;
  }
  // the tail: this block's slice of basis, zoneset, leftovers and open count,
  // by warps 1.. while warp 0 of a block past row 0 looks back
  const bool lookback = w > 0 && w < W;
  {
    const long long tail = (long long)N + (long long)N * D + W + 1;
    const long long per = (tail + gridDim.x - 1) / gridDim.x;
    const long long lo = (long long)w * per, hi = min(tail, lo + per);
    const int t0 = lookback ? tid - 32 : tid, nt = lookback ? NT - 32 : NT;
    int* out = flat + 3 * (size_t)nnz_cap;
    for (long long k = lo + t0; t0 >= 0 && k < hi; k += nt) {
      int v;
      if (k < N) v = slot_basis[k];
      else if (k < N + (long long)N * D) v = slot_zoneset[k - N] != 0;
      else if (k < tail - 1) v = leftovers[k - N - (long long)N * D];
      else v = open_count[0];
      out[k] = v;
    }
  }
  if (lookback && tid < 32) {
    int j = w - 1, sum = 0;
    while (true) {
      const int k = j - lane;
      unsigned long long word = tag_p;  // before row 0: a prefix of 0
      if (k >= 0) {
        do {
          word = status[k];
        } while ((word >> 32) < (tag_a >> 32));
      }
      const unsigned pm = __ballot_sync(FULL, (word >> 32) == (tag_p >> 32));
      const int first = pm ? __ffs(pm) - 1 : 32;
      sum += (int)__reduce_add_sync(FULL, lane <= first ? (unsigned)(word & 0xffffffffu) : 0u);
      if (pm) break;
      j -= 32;
    }
    if (lane == 0) {
      status[w] = tag_p | (unsigned)(sum + total);
      sh_excl = sum;
    }
  }
  __syncthreads();
  if (w < W) {
    excl = w == 0 ? 0 : sh_excl;
    // compaction in slot order: thread t takes slots [base + 16 t, base + 16 t + 16)
    int run = 0;
    for (int base = 0; base < N; base += TILE) {
      const int j0 = base + PER * tid;
      int vals[PER];
      int c = 0;
      if (j0 + PER <= min(N, cap)) {
#pragma unroll
        for (int q = 0; q < PER; q += 4) {
          const int4 v = reinterpret_cast<const int4*>(row_s + j0)[q / 4];
          vals[q] = v.x;
          vals[q + 1] = v.y;
          vals[q + 2] = v.z;
          vals[q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          const int j = j0 + q;
          vals[q] = j < N ? (j < cap ? row_s[j] : row[j]) : 0;
        }
      }
#pragma unroll
      for (int q = 0; q < PER; ++q) c += vals[q] != 0;
      int off, agg;
      Scan(temp.scan).ExclusiveSum(c, off, agg);
      int pos = excl + run + off;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        if (vals[q] != 0) {
          if (pos < nnz_cap) {
            flat[pos] = w;
            flat[nnz_cap + pos] = j0 + q;
            flat[2 * (size_t)nnz_cap + pos] = vals[q];
          }
          ++pos;
        }
      }
      run += agg;
      __syncthreads();  // temp is reused
    }
  }
  // the padding past the total, by the block of the last row (or the only block when W = 0)
  if (w == (W > 0 ? W - 1 : 0)) {
    const int used = W > 0 ? min(excl + total, nnz_cap) : 0;
    for (int k = used + tid; k < nnz_cap; k += NT) {
      flat[k] = -1;
      flat[nnz_cap + k] = -1;
      flat[2 * (size_t)nnz_cap + k] = 0;
    }
  }
  // the last block to finish readies the scratch for the next call
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(&st[1], 1ull) == gridDim.x - 1) {
      vst[0] = 0;
      vst[1] = 0;
      vst[2] = sh_epoch + 1u;
    }
  }
}

// scratch: 4 + W uint64 words, zeroed once when allocated; the kernel leaves it so
extern "C" int kt_sparsify(const void* takes, const void* leftovers, const void* slot_basis, const void* slot_zoneset,
                           const void* open_count, int W, int N, int D, int nnz_cap, void* scratch, void* flat,
                           void* stream) {
  const int cap = N < ROW_CAP ? ((N + 3) & ~3) : ROW_CAP;
  const size_t smem = (size_t)cap * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(sparsify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sparsify_kernel<<<W > 0 ? W : 1, NT, smem, (cudaStream_t)stream>>>(
      (const int*)takes, W, N, D, nnz_cap, (const int*)leftovers, (const int*)slot_basis,
      (const uint8_t*)slot_zoneset, (const int*)open_count, (unsigned long long*)scratch, (int*)flat, cap);
  return (int)cudaGetLastError();
}
