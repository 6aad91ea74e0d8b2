// merge_kernel_tiled: the stable merge of two sorted device runs, on the
// card.
//
// Replaces the reference package's ops/merge.py merge_kernel_tiled (:104):
// keys (n, 3) and (m, 3) uint32 [lo0, lo1, pad], compared as unsigned
// words with the most significant word last, each run sorted; payloads
// (n, 3) and (m, 3) ride along. The output is the (n + m)-row merge, and at
// equal keys every row of A comes before every row of B (the flush passes
// the older run as A). ops/merge.py merge_kernel_tiled_plain is the same
// function in PyTorch.
//
// What bounds it on this card: bytes. Each input row is read once and each
// output row written once, 24 bytes a row; the diagonal searches and the
// per-row binary searches in shared memory add O(log) work a row, which at
// the flush's 40,960-163,840 rows stays far below the device's rate.
//
// Design: one thread block of `tile` threads per `tile`-row output tile;
// the merge path (the diagonal searches and the in-tile ranks) lives in
// merge_path.cuh, which the compaction fold (compact_fold_kernel.cu) shares.
#include "common.cuh"
#include "merge_path.cuh"

namespace {

__global__ void merge_tiles(const uint32_t* __restrict__ ka,
                            const uint32_t* __restrict__ pa,
                            const uint32_t* __restrict__ kb,
                            const uint32_t* __restrict__ pb,
                            uint32_t* __restrict__ ok,
                            uint32_t* __restrict__ op, long long n,
                            long long m, int tile) {
  extern __shared__ uint32_t sk[];  // [tile][3]: the tile's A rows, then B
  tb::merge_path::merge_tile(ka, pa, n, kb, pb, m, ok, op,
                             (long long)blockIdx.x * tile, tile, sk);
}

}  // namespace

// ka, pa (n, 3), kb, pb (m, 3) -> ok, op (n + m, 3); all uint32,
// contiguous; 1 <= tile <= 1024 and tile divides n + m.
extern "C" int tb_merge_kernel_tiled(const void* ka, const void* pa,
                                     const void* kb, const void* pb, void* ok,
                                     void* op, long long n, long long m,
                                     long long tile, void* stream) {
  if (tile < 1 || tile > 1024 || n < 0 || m < 0 || (n + m) % tile != 0) {
    return (int)cudaErrorInvalidValue;
  }
  long long tiles = (n + m) / tile;
  if (tiles == 0) return (int)cudaSuccess;
  if (tiles > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  merge_tiles<<<(unsigned)tiles, (unsigned)tile, (size_t)tile * 3 * 4,
                static_cast<cudaStream_t>(stream)>>>(
      (const uint32_t*)ka, (const uint32_t*)pa, (const uint32_t*)kb,
      (const uint32_t*)pb, (uint32_t*)ok, (uint32_t*)op, n, m, (int)tile);
  return (int)cudaGetLastError();
}
