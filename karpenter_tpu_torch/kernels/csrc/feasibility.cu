// K1 feasibility: item x row requirement compatibility and the new-slot row
// preference key, fused.
//
// Replaces: karpenter_tpu/models/scheduler_model.py `compat_matrix` (:436,
// with ops/bitset.py `test_bit` :35) and `row_choose_key` (:454), as called
// at the top of the grouped pack (scheduler_model_grouped.py:547-548).
//
// What bounds it on an H100: neither bytes nor arithmetic at the headline
// shape (640 x 128 outputs, ~0.5 MB moved, a few MFLOP): it is one small
// launch, bound by launch latency and one wave of thread blocks.
//
// Design: one thread per (item, row) on a 2-D grid, looping over the K
// label keys (test_bit semantics: word index clamped to Words-1, negative
// label id is false, dom-key columns forced true), ANDing the taint bit,
// then looping over R for the choose key. Bit-parity: IEEE division and no
// FMA contraction (built with -fmad=false, explicit __f*_rn).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void feasibility_kernel(const int* __restrict__ row_labels, const int* __restrict__ row_taint_class,
                                   const float* __restrict__ row_alloc, const int* __restrict__ row_pool_rank,
                                   const uint32_t* __restrict__ item_mask, const uint8_t* __restrict__ taint_ok,
                                   const float* __restrict__ item_req, const uint8_t* __restrict__ forced_keys,
                                   int W, int Nrows, int K, int Words, int C, int R, uint8_t* __restrict__ compat,
                                   float* __restrict__ key) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  int w = blockIdx.y;
  if (r >= Nrows || w >= W) return;
  bool ok = true;
  const uint32_t* mask = item_mask + (size_t)w * K * Words;
  for (int k = 0; k < K && ok; ++k) {
    if (forced_keys[k]) continue;
    int idx = row_labels[(size_t)r * K + k];
    if (idx < 0) {
      ok = false;
      break;
    }
    int word = min(idx >> 5, Words - 1);
    ok = ((mask[k * Words + word] >> (idx & 31)) & 1u) != 0;
  }
  int tc = min(max(row_taint_class[r], 0), C - 1);
  ok = ok && taint_ok[(size_t)w * C + tc] != 0;
  compat[(size_t)w * Nrows + r] = ok ? 1 : 0;

  float score = 0.f;
  for (int k = 0; k < R; ++k) {
    float q = __fdiv_rn(row_alloc[(size_t)r * R + k], fmaxf(item_req[(size_t)w * R + k], 1e-6f));
    score = k == 0 ? q : fminf(score, q);
  }
  key[(size_t)w * Nrows + r] = __fsub_rn(__fmul_rn((float)row_pool_rank[r], 1e9f), fminf(score, 1e8f));
}

extern "C" int kt_feasibility(const void* row_labels, const void* row_taint_class, const void* row_alloc,
                              const void* row_pool_rank, const void* item_mask, const void* taint_ok,
                              const void* item_req, const void* forced_keys, int W, int Nrows, int K, int Words,
                              int C, int R, void* compat, void* key, void* stream) {
  dim3 block(128);
  dim3 grid((Nrows + 127) / 128, W);
  feasibility_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)row_labels, (const int*)row_taint_class, (const float*)row_alloc, (const int*)row_pool_rank,
      (const uint32_t*)item_mask, (const uint8_t*)taint_ok, (const float*)item_req, (const uint8_t*)forced_keys, W,
      Nrows, K, Words, C, R, (uint8_t*)compat, (float*)key);
  return (int)cudaGetLastError();
}
