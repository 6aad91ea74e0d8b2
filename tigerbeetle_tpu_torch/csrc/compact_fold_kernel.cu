// compact_fold_kernel: one compaction chunk's k-way fold, on the card.
//
// Replaces the reference package's ops/merge.py compact_fold_kernel
// (:283): keys (k, b, 3) and payloads (k, b, 3) uint32, k sorted runs of
// b rows each in the merge's run format (merge_path.cuh), stacked oldest
// first, k and b powers of two, b a multiple of the 256-row tile (pad rows
// [0, 0, 1] sort last). The output is the (k b)-row stable merge of the k
// runs: at equal keys an older run's rows come first, as in the
// reference's pairwise tree fold. ops/merge.py compact_fold_kernel_plain
// (the stable sort of the concatenation) is the same function in PyTorch.
//
// What bounds it on this card: bytes. The function reads each input row
// once and writes each output row once (24 bytes a row each way); the fold
// itself moves every row once per level, log2(k) levels, and the diagonal
// and in-tile searches add O(log) work a row.
//
// Design: log2(k) launches, one per level of the pairwise fold. At level L
// the runs are r = b << L rows and pair p merges rows [2 p r, 2 p r + r)
// with [2 p r + r, 2 p r + 2 r) into rows [2 p r, 2 p r + 2 r) of the next
// buffer, so one grid of k b / 256 blocks covers every pair and every
// output tile at once (block = one 256-row tile of one pair, through
// merge_path.cuh's merge_tile). Levels ping-pong between the output and
// one scratch buffer, both allocated once by the wrapper, with the
// parity chosen so that the last level lands in the output; the input is
// never written. Launches queue on one stream: no host sync between
// levels.
#include "common.cuh"
#include "merge_path.cuh"

namespace {

constexpr int kTile = 256;

__global__ void fold_level(const uint32_t* __restrict__ sk_in,
                           const uint32_t* __restrict__ sp_in,
                           uint32_t* __restrict__ sk_out,
                           uint32_t* __restrict__ sp_out, long long r) {
  extern __shared__ uint32_t sk[];  // [kTile][3]
  long long tiles_per_pair = (2 * r) / kTile;
  long long pair = blockIdx.x / tiles_per_pair;
  long long d0 = (blockIdx.x % tiles_per_pair) * kTile;
  long long base = pair * 2 * r;  // first row of the pair
  const uint32_t* ka = sk_in + 3 * base;
  const uint32_t* pa = sp_in + 3 * base;
  const uint32_t* kb = ka + 3 * r;
  const uint32_t* pb = pa + 3 * r;
  tb::merge_path::merge_tile(ka, pa, r, kb, pb, r, sk_out + 3 * base,
                             sp_out + 3 * base, d0, kTile, sk);
}

bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// keys, pays (k, b, 3) -> out_keys, out_pays (k b, 3); scratch_keys and
// scratch_pays (k b, 3) are the other half of the ping-pong (unused for
// k = 2). All uint32, contiguous; k >= 2 and b >= 256 powers of two.
extern "C" int tb_compact_fold(const void* keys, const void* pays,
                               void* out_keys, void* out_pays,
                               void* scratch_keys, void* scratch_pays,
                               long long k, long long b, void* stream) {
  if (!pow2(k) || k < 2 || !pow2(b) || b < kTile) {
    return (int)cudaErrorInvalidValue;
  }
  long long blocks = k * b / kTile;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  int levels = 0;
  while ((1ll << levels) < k) ++levels;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in_k = (const uint32_t*)keys;
  const uint32_t* in_p = (const uint32_t*)pays;
  for (int level = 0; level < levels; ++level) {
    // The last level writes the output; the ones before alternate.
    bool to_out = ((levels - 1 - level) & 1) == 0;
    uint32_t* dk = (uint32_t*)(to_out ? out_keys : scratch_keys);
    uint32_t* dp = (uint32_t*)(to_out ? out_pays : scratch_pays);
    fold_level<<<(unsigned)blocks, kTile, (size_t)kTile * 3 * 4, s>>>(
        in_k, in_p, dk, dp, b << level);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    in_k = dk;
    in_p = dp;
  }
  return (int)cudaSuccess;
}
