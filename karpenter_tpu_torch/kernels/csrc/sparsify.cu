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
//
// Design: three passes keep the row-major order of jnp.nonzero without
// atomics: (1) one block per item row counts its nonzeros; (2) one block
// takes the exclusive scan of the row counts; (3) one block per row
// compacts its nonzeros in slot order with a block scan of the nonzero
// flags and a running offset across 1024-slot chunks. Entries past nnz_cap
// are dropped, as the reference's fixed-size nonzero drops them. A fourth
// grid-strided pass writes the padding and the tail of the flat vector.
// The take matrix is read twice (passes 1 and 3); a single-pass
// decoupled-lookback scan would read it once.

#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <stdint.h>

#define NT 1024

__global__ void __launch_bounds__(NT) count_kernel(const int* __restrict__ takes, int N, int* __restrict__ row_cnt) {
  typedef cub::BlockReduce<int, NT> Red;
  __shared__ typename Red::TempStorage temp;
  const int* row = takes + (size_t)blockIdx.x * N;
  int c = 0;
  for (int j = threadIdx.x; j < N; j += NT) c += row[j] != 0;
  int total = Red(temp).Sum(c);
  if (threadIdx.x == 0) row_cnt[blockIdx.x] = total;
}

__global__ void __launch_bounds__(NT) scan_kernel(const int* __restrict__ row_cnt, int W, int* __restrict__ row_off) {
  typedef cub::BlockScan<int, NT> Scan;
  __shared__ typename Scan::TempStorage temp;
  int run = 0;
  for (int base = 0; base < W; base += NT) {
    int w = base + threadIdx.x;
    int v = w < W ? row_cnt[w] : 0;
    int pre, agg;
    Scan(temp).ExclusiveSum(v, pre, agg);
    __syncthreads();
    if (w < W) row_off[w] = run + pre;
    run += agg;
  }
  if (threadIdx.x == 0) row_off[W] = run;
}

__global__ void __launch_bounds__(NT) write_kernel(const int* __restrict__ takes, int N, int nnz_cap,
                                                   const int* __restrict__ row_off, int* __restrict__ flat) {
  typedef cub::BlockScan<int, NT> Scan;
  __shared__ typename Scan::TempStorage temp;
  const int w = blockIdx.x;
  const int* row = takes + (size_t)w * N;
  int run = row_off[w];
  for (int base = 0; base < N; base += NT) {
    int j = base + threadIdx.x;
    int v = j < N ? row[j] : 0;
    int flag = v != 0, pre, agg;
    Scan(temp).ExclusiveSum(flag, pre, agg);
    __syncthreads();
    int pos = run + pre;
    if (flag && pos < nnz_cap) {
      flat[pos] = w;
      flat[nnz_cap + pos] = j;
      flat[2 * nnz_cap + pos] = v;
    }
    run += agg;
  }
}

__global__ void tail_kernel(const int* __restrict__ row_off, int W, int N, int D, int nnz_cap,
                            const int* __restrict__ leftovers, const int* __restrict__ slot_basis,
                            const uint8_t* __restrict__ slot_zoneset, const int* __restrict__ open_count,
                            int* __restrict__ flat) {
  const int total = min(row_off[W], nnz_cap);
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t start = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  int* tail = flat + 3 * (size_t)nnz_cap;
  for (size_t k = start; k < (size_t)nnz_cap; k += stride) {
    if ((int)k >= total) {
      flat[k] = -1;
      flat[nnz_cap + k] = -1;
      flat[2 * (size_t)nnz_cap + k] = 0;
    }
  }
  for (size_t k = start; k < (size_t)N; k += stride) tail[k] = slot_basis[k];
  for (size_t k = start; k < (size_t)N * D; k += stride) tail[N + k] = slot_zoneset[k] != 0;
  for (size_t k = start; k < (size_t)W; k += stride) tail[N + (size_t)N * D + k] = leftovers[k];
  if (start == 0) tail[N + (size_t)N * D + W] = open_count[0];
}

// scratch: [2 W + 1] int32
extern "C" int kt_sparsify(const void* takes, const void* leftovers, const void* slot_basis, const void* slot_zoneset,
                           const void* open_count, int W, int N, int D, int nnz_cap, void* scratch, void* flat,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int* row_cnt = (int*)scratch;
  int* row_off = row_cnt + W;
  count_kernel<<<W, NT, 0, st>>>((const int*)takes, N, row_cnt);
  scan_kernel<<<1, NT, 0, st>>>(row_cnt, W, row_off);
  write_kernel<<<W, NT, 0, st>>>((const int*)takes, N, nnz_cap, row_off, (int*)flat);
  tail_kernel<<<132, 256, 0, st>>>(row_off, W, N, D, nnz_cap, (const int*)leftovers, (const int*)slot_basis,
                                   (const uint8_t*)slot_zoneset, (const int*)open_count, (int*)flat);
  return (int)cudaGetLastError();
}
