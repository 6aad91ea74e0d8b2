// merge_kernel: the stable merge of two sorted device runs, any run lengths
// and any payload width, on the card.
//
// Replaces the reference package's ops/merge.py merge_kernel (:73): keys
// (n, 3) and (m, 3) uint32 in the merge's run format (merge_path.cuh),
// each run sorted; payload rows of K >= 1 uint32 words each ride along.
// The output is the (n + m)-row merge, and at equal keys every row of A
// comes before every row of B. No tile alignment; either run may be empty.
// ops/merge.py merge_kernel_plain (the stable sort of the concatenation)
// is the same function in PyTorch.
//
// What bounds it on this card: bytes, (12 + 4 K) a row read and written
// once: 7.86 MB at the flush's 122,880 + 40,960 rows and K = 3, about
// 2.3 us. As for the tiled merge (merge_kernel_tiled.cu, the same work at
// K = 3), every block runs its phases at once with every other at that
// size, so each phase's round trips to L2 count more than the bytes.
//
// Design: the tiled merge's (merge_kernel_tiled.cu, whose co-rank search
// and span staging live in merge_path.cuh), with the payload taken from
// device memory by each output row's source instead of staged:
//   1. Co-ranks: warps 0 and 1 find how many rows of A the outputs before
//      the tile and before its end take, by warp-wide searches.
//   2. The tile's A and B key spans go to shared memory: their whole
//      16-byte chunks by two TMA bulk copies completing on one mbarrier,
//      the words of the partial chunks at each end (a span starts at 12 a0
//      bytes) by plain loads beside them.
//   3. Each thread merges kRows consecutive outputs: a merge-path search
//      in shared memory for its start, then kRows serial steps with both
//      heads in registers, recording each output's source row (the tile's
//      A row i, or B row j as na + j) in shared memory.
//   4. The keys are staged in shared memory and stored as 16-byte
//      vectors. The payload tile (K rows words from K d0, a multiple of 4)
//      is stored as 16-byte vectors too, each thread's four words loaded
//      from the payload spans by their rows' sources: within a tile each
//      side's span is contiguous, so a warp's loads fall on few lines.
//      A thread loads kVecs vectors' words before it stores any, so it
//      waits on one round of loads for them. Nothing of the payload is
//      held in shared memory, so one kernel serves every width. (An L1
//      prefetch of the payload spans during the merge was tried and
//      measured no faster; PERF.md §6.)
// Launched as a programmatic dependent of the kernel before it on the
// stream, as the tiled merge is.
#include "common.cuh"
#include "merge_path.cuh"

namespace {

using tb::merge_path::a_taken_warp;
using tb::merge_path::bulk_bytes;
using tb::merge_path::bulk_span;
using tb::merge_path::edge_word;
using tb::merge_path::key_le_words;
using tb::merge_path::smem_addr;
using tb::merge_path::store_tile;
using tb::merge_path::wait_phase0;

constexpr int kThreads = 128;
constexpr int kRows = 3;  // outputs a thread: odd, so a warp's 3 kRows word strides miss banks
constexpr int kTile = kThreads * kRows;
constexpr int kVecs = 4;  // payload vectors a thread loads before it stores
// Words of the key buffer: both spans (kTile rows), each shifted by up to
// 3 words in its chunk, B's start rounded up to a chunk.
constexpr int kSpanWords = 3 * kTile + 12;
static_assert(kRows % 2 == 1, "kRows must be odd");
static_assert(kTile % 4 == 0, "a tile must start on a 16-byte boundary");
static_assert(kTile < 65536, "sources are 16-bit");

constexpr int top_step(int n) { return n < 2 ? 1 : 2 * top_step(n / 2); }
constexpr int kTopStep = top_step(kTile);

__global__ void __launch_bounds__(kThreads)
merge_tiles(const uint32_t* __restrict__ ka, const uint32_t* __restrict__ pa,
            const uint32_t* __restrict__ kb, const uint32_t* __restrict__ pb,
            uint32_t* __restrict__ ok, uint32_t* __restrict__ op, long long n,
            long long m, long long width) {
  __shared__ __align__(16) uint32_t s_key[kSpanWords];
  __shared__ uint16_t s_src[kTile];  // output row -> i (A) or na + j (B)
  __shared__ long long s_split[2];
  __shared__ uint64_t s_bar;  // the key spans' bulk copies
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const unsigned bar = smem_addr(&s_bar);
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  const long long d0 = (long long)blockIdx.x * kTile;
  const long long d1 = d0 + kTile < n + m ? d0 + kTile : n + m;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // 1. The tile's co-ranks, one warp each.
  if (warp < 2) {
    long long a = a_taken_warp(ka, n, kb, m, warp ? d1 : d0, lane);
    if (lane == 0) s_split[warp] = a;
  }
  __syncthreads();
  const long long a0 = s_split[0], b0 = d0 - a0;
  const int rows = (int)(d1 - d0);
  const int na = (int)(s_split[1] - a0), nb = rows - na;

  // 2. Both key spans to shared memory: thread 0 issues the bulk copies,
  // threads 0-11 copy the edge words, every thread waits for the
  // mbarrier's first phase.
  const int sa = (int)((3 * a0) & 3), sb = (int)((3 * b0) & 3);
  const int bbase = (sa + 3 * na + 3) & ~3;
  const long long wa0 = 3 * a0, wa1 = 3 * (a0 + na), wb0 = 3 * b0, wb1 = 3 * (b0 + nb);
  if (t == 0) {
    const long long bytes = bulk_bytes(wa0, wa1) + bulk_bytes(wb0, wb1);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"((unsigned)bytes)
                 : "memory");
    bulk_span(s_key, ka, wa0, wa1, bar);
    bulk_span(s_key + bbase, kb, wb0, wb1, bar);
  }
  if (t < 12) {  // six edge slots a span
    if (t < 6) {
      edge_word(s_key, ka, wa0, wa1, t);
    } else {
      edge_word(s_key + bbase, kb, wb0, wb1, t - 6);
    }
  }
  wait_phase0(bar);
  __syncthreads();  // the spans are in shared memory

  // 3. This thread's kRows outputs, from output row `diag` of the tile:
  // how many of A's rows the outputs before it take (the least c in
  // [lo, hi] with A[c] > B[diag - c - 1]), then the merge.
  const uint32_t* A = s_key + sa;
  const uint32_t* B = s_key + bbase + sb;
  const int diag = t * kRows < rows ? t * kRows : rows;
  const int lo = diag - nb > 0 ? diag - nb : 0;
  const int hi = diag < na ? diag : na;
  int c = lo;
#pragma unroll
  for (int step = kTopStep; step > 0; step >>= 1) {
    if (c + step <= hi) {
      const uint32_t* x = A + 3 * (c + step - 1);
      const uint32_t* y = B + 3 * (diag - c - step);
      if (key_le_words(x[0], x[1], x[2], y[0], y[1], y[2])) c += step;
    }
  }
  int i = c, j = diag - c;
  // Both heads in registers (a side's last row stands in past its end).
  const int ia = sa + 3 * (i < na ? i : na - 1), jb = bbase + sb + 3 * (j < nb ? j : nb - 1);
  uint32_t ha[3], hb[3], rk[kRows][3];
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    ha[w] = na ? s_key[ia + w] : 0u;
    hb[w] = nb ? s_key[jb + w] : 0u;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (diag + r < rows) {
      const bool take_a =
          j >= nb || (i < na && key_le_words(ha[0], ha[1], ha[2], hb[0], hb[1], hb[2]));
      s_src[diag + r] = (uint16_t)(take_a ? i : na + j);
      if (take_a) ++i; else ++j;
      const int next = take_a ? sa + 3 * (i < na ? i : na - 1)
                              : bbase + sb + 3 * (j < nb ? j : nb - 1);
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        rk[r][w] = take_a ? ha[w] : hb[w];
        const uint32_t nk = s_key[next + w];
        ha[w] = take_a ? nk : ha[w];
        hb[w] = take_a ? hb[w] : nk;
      }
    }
  }
  __syncthreads();  // every span row read: the buffer takes the output

  // 4. Stage the keys and store them; then the payload tile.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (diag + r < rows) {
#pragma unroll
      for (int w = 0; w < 3; ++w) s_key[3 * (diag + r) + w] = rk[r][w];
    }
  }
  __syncthreads();
  store_tile(ok + 3 * d0, s_key, 3 * rows, kThreads);

  // Word 4 v + u of the payload tile is word `col` of output row `row`.
  // A thread's vectors are v = t + kThreads i: one division places the
  // first, a fixed step each next one. kVecs of them are loaded before
  // any is stored, so a thread waits on one round of loads for them.
  uint32_t* const out = op + width * d0;
  const long long words = width * rows, vecs = words >> 2;
  const uint32_t* const src_a = pa + width * a0;
  const uint32_t* const src_b = pb + width * b0;
  long long row = 4 * t / width, col = 4 * t - row * width;
  const long long step_rows = 4 * kThreads / width, step_col = 4 * kThreads - step_rows * width;
  for (long long v0 = t; v0 < vecs; v0 += kVecs * kThreads) {
    uint32_t q[kVecs][4];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (v0 + i * kThreads < vecs) {
        long long r = row, w = col;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = s_src[r];
          q[i][u] = __ldg((s < na ? src_a + s * width : src_b + (s - na) * width) + w);
          if (++w == width) {
            w = 0;
            ++r;
          }
        }
      }
      row += step_rows;
      col += step_col;
      if (col >= width) {
        col -= width;
        ++row;
      }
    }
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (v0 + i * kThreads < vecs) {
        reinterpret_cast<uint4*>(out)[v0 + i * kThreads] =
            make_uint4(q[i][0], q[i][1], q[i][2], q[i][3]);
      }
    }
  }
  for (long long x = 4 * vecs + t; x < words; x += kThreads) {  // the last tile's tail
    const long long r = x / width, w = x - r * width;
    const int s = s_src[r];
    out[x] = s < na ? src_a[s * width + w] : src_b[(s - na) * width + w];
  }
}

}  // namespace

// ka (n, 3), pa (n, width), kb (m, 3), pb (m, width) -> ok (n + m, 3),
// op (n + m, width); all uint32, contiguous, 16-byte aligned; width >= 1.
extern "C" int tb_merge_kernel(const void* ka, const void* pa, const void* kb,
                               const void* pb, void* ok, void* op, long long n,
                               long long m, long long width, void* stream) {
  if (n < 0 || m < 0 || width < 1 || width > 0x7FFFFFFFll) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = (n + m + kTile - 1) / kTile;
  if (tiles == 0) return (int)cudaSuccess;
  if (tiles > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute chained[1];
  chained[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  chained[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = chained;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, merge_tiles, (const uint32_t*)ka, (const uint32_t*)pa, (const uint32_t*)kb,
      (const uint32_t*)pb, (uint32_t*)ok, (uint32_t*)op, n, m, width);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
