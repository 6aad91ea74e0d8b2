// compact_fold_kernel: one compaction chunk's k-way fold, on the card.
//
// Replaces the reference package's ops/merge.py compact_fold_kernel
// (:283): keys (k, b, 3) and payloads (k, b, 3) uint32, k sorted runs of
// b rows each in the merge's run format (ops/merge.py), stacked oldest
// first, k and b powers of two, b >= 256 (pad rows [0, 0, 1] sort last).
// The output is the (k b)-row stable merge of the k runs: at equal keys an
// older run's rows come first, as in the reference's pairwise tree fold.
// ops/merge.py compact_fold_kernel_plain (the stable sort of the
// concatenation) is the same function in PyTorch.
//
// What bounds it on this card: bytes. The function reads each input row
// once and writes each output row once (24 bytes a row each way).
//
// Design: one cooperative launch, two blocks of 512 threads on each SM (one
// merges in shared memory while the other moves rows), that reads every
// row once and writes it once. The merge's order is total: (key, run,
// row). Three phases, with a grid barrier between each:
//   1. Samples. Every S-th row of every run is a sample (k S <= 2048). For
//      each sample and each other run, a binary search gives how many of
//      that run's rows precede it (<= against older runs, < against newer
//      ones), first in a table of every run's rows at a stride that each
//      block holds in shared memory, then within one stride in device
//      memory; one group of lanes a sample (consecutive samples on
//      different SMs) sums them into the sample's output rank and its
//      place among all samples, and writes the sample there: the samples,
//      sorted, with their ranks and co-ranks.
//   2. Splits. Output tile t aims at rows [2048 t, 2048 (t + 1)); its
//      start is the last sample of rank <= 2048 t. Between two samples
//      adjacent in order lie fewer than k S rows, so a tile holds at most
//      2048 + 2048 rows, and the co-ranks of its two splitting samples
//      give each run's segment of it exactly.
//   3. Tiles, taken by the blocks from a queue (the next tile's co-ranks
//      load while a tile merges). A block copies a tile's k segments of
//      keys into shared memory (cp.async, coalesced), merges them there as
//      a pairwise tree of log2(k) levels over 16-bit row indices (each
//      thread one merge-path search, then a sequential merge of its few
//      outputs with the two candidate keys in registers), writes the keys
//      in output order, then copies the payloads in where the keys were
//      and writes them in the same order, all coalesced.
// The sample stride trades the phases: a larger k S means fewer samples
// (phase 1 does k (k - 1) b / S binary searches) but larger tiles, which
// fit fewer blocks on an SM.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;           // one merges while another moves data
constexpr int kTile = 2048;               // output rows a tile aims at
constexpr int kSlack = 2048;              // k * S <= kSlack
constexpr int kTileMax = kTile + kSlack;  // the most rows a tile holds
constexpr int kMaxRuns = kThreads;        // one thread a run in the segment scan
// A tile's keys (then its payloads), two orders of its rows, and each
// run's segment of it.
constexpr size_t kSmem = (size_t)kTileMax * 3 * 4 + (size_t)kTileMax * 2 * 2 +
                         (size_t)(2 * kMaxRuns + 1) * 4;

static_assert(kTileMax <= 65536, "16-bit row indices");

struct Args {
  const uint32_t* keys;  // (k, b, 3)
  const uint32_t* pays;
  uint32_t* out_keys;    // (k b, 3)
  uint32_t* out_pays;
  int* co;               // [ns][k] co-ranks of each sample
  int* sorted_rank;      // [ns] output rank of the sample at each place
  int* sorted_id;        // [ns] the sample at each place
  int* tile_sample;      // [ntiles] the sample a tile starts at
  int* tile_rank;        // [ntiles] and its output rank
  int* next_tile;        // the tiles' queue: the next tile a block takes
  int k, b, s, ns, ntiles;
  int table;             // phase 1's table rows a run (a power of two <= b)
};

__shared__ int s_warp[32];
__shared__ int s_next;  // the tile a block takes after its current one

// a < b on three-word keys, the last word most significant.
__device__ __forceinline__ bool key_lt(uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t b0, uint32_t b1, uint32_t b2) {
  unsigned long long ah = ((unsigned long long)a2 << 32) | a1;
  unsigned long long bh = ((unsigned long long)b2 << 32) | b1;
  return ah < bh || (ah == bh && a0 < b0);
}

// Rows of the sorted run `run` (b rows) before key (k0, k1, k2): those
// <= it (inclusive) or < it. `tab` holds the run's rows e b / n for e < n
// (three words each): it narrows the search to one stride of rows.
__device__ int count_before(const uint32_t* __restrict__ run, int b, const uint32_t* tab,
                            int n, uint32_t k0, uint32_t k1, uint32_t k2, bool inclusive) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    const uint32_t* r = tab + 3 * mid;
    bool before = inclusive ? !key_lt(k0, k1, k2, r[0], r[1], r[2])
                            : key_lt(r[0], r[1], r[2], k0, k1, k2);
    if (before) lo = mid + 1; else hi = mid;
  }
  // Table rows below lo are before the key, those from lo on are not.
  const int stride = b / n;
  hi = lo < n ? lo * stride : b;
  lo = lo ? (lo - 1) * stride + 1 : 0;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    const uint32_t* r = run + 3 * (long long)mid;
    uint32_t r0 = __ldg(r), r1 = __ldg(r + 1), r2 = __ldg(r + 2);
    bool before = inclusive ? !key_lt(k0, k1, k2, r0, r1, r2)
                            : key_lt(r0, r1, r2, k0, k1, k2);
    if (before) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Block-wide exclusive sum; every thread passes one value.
__device__ int block_excl_sum(int v) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kThreads / 32 ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int before = warp ? s_warp[warp - 1] : 0;
  __syncthreads();
  return before + x - v;
}

__device__ __forceinline__ void copy_word(uint32_t* dst, const uint32_t* src) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// Phase 1: each sample's co-ranks, output rank and place among samples.
// Every block first copies the runs' rows at a stride into `table` (a
// run's rows one entry apart from the next run's, against bank
// conflicts).
__device__ void rank_samples(const Args& a, uint32_t* table) {
  const int n = a.table, stride = a.b / n;
  for (int e = threadIdx.x; e < a.k * n; e += kThreads) {
    int r = e / n, i = e % n;
    const uint32_t* src = a.keys + 3 * ((long long)r * a.b + (long long)i * stride);
    uint32_t* dst = table + 3 * (r * (n + 1) + i);
    for (int w = 0; w < 3; ++w) copy_word(dst + w, src + w);
  }
  copy_wait();
  const int g = a.k < 32 ? a.k : 32;  // lanes a sample
  const int per_warp = 32 / g;
  const int lane = threadIdx.x & 31, sub = lane % g;
  // Consecutive samples go to different blocks, so every SM searches.
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  const long long warp = (long long)(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const int nq = a.b / a.s;
  for (long long first = warp * per_warp; first < a.ns; first += warps * per_warp) {
    long long smp = first + lane / g;
    bool active = smp < a.ns;
    int rank = 0, place = 0;
    if (active) {
      int j = (int)(smp / nq), q = (int)(smp % nq);
      const uint32_t* key = a.keys + 3 * ((long long)j * a.b + (long long)q * a.s);
      uint32_t k0 = __ldg(key), k1 = __ldg(key + 1), k2 = __ldg(key + 2);
      for (int r = sub; r < a.k; r += g) {
        int c = r == j ? q * a.s
                       : count_before(a.keys + 3 * (long long)r * a.b, a.b,
                                      table + 3 * r * (n + 1), n, k0, k1, k2, r < j);
        a.co[smp * a.k + r] = c;
        rank += c;
        place += r == j ? q : (c + a.s - 1) / a.s;
      }
    }
    for (int o = g >> 1; o; o >>= 1) {
      rank += __shfl_xor_sync(0xFFFFFFFFu, rank, o);
      place += __shfl_xor_sync(0xFFFFFFFFu, place, o);
    }
    if (active && sub == 0) {
      a.sorted_rank[place] = rank;
      a.sorted_id[place] = (int)smp;
    }
  }
}

// Phase 2: the tile boundaries 2048 t in [rank(p), rank(p + 1)) start at
// the sample at place p (adjacent samples are fewer than kSlack ranks
// apart; a tile between two boundaries of one gap is empty).
__device__ void split_tiles(const Args& a) {
  const long long total = (long long)a.k * a.b;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < a.ns;
       p += (long long)gridDim.x * kThreads) {
    long long r0 = __ldcg(a.sorted_rank + p);
    long long r1 = p + 1 < a.ns ? __ldcg(a.sorted_rank + p + 1) : total;
    for (long long t = (r0 + kTile - 1) / kTile; t * kTile < r1 && t < a.ntiles; ++t) {
      a.tile_sample[t] = __ldcg(a.sorted_id + p);
      a.tile_rank[t] = (int)r0;
    }
  }
}

// The segment holding tile row r: the last j with off[j] <= r.
__device__ __forceinline__ int segment_of(const int* off, int k, int r) {
  int lo = 0, hi = k - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= r) lo = mid; else hi = mid - 1;
  }
  return lo;
}

struct Key {
  uint32_t w0, w1, w2;
};

__device__ __forceinline__ Key key_at(const uint32_t* sk, int row) {
  const uint32_t* p = sk + 3 * row;
  return {p[0], p[1], p[2]};
}

__device__ __forceinline__ bool key_lt(const Key& a, const Key& b) {
  return key_lt(a.w0, a.w1, a.w2, b.w0, b.w1, b.w2);
}

// The tile row at place p of the previous level's order (at level 1, the
// tile's own order).
template <bool kFirst>
__device__ __forceinline__ int row_at(const uint16_t* src, int p) {
  return kFirst ? p : src[p];
}

// One level of the in-tile tree for the outputs [x, x1): groups of gs
// segments merge in pairs, A (the older) first at equal keys; the next
// row of each side and its key stay in registers.
template <bool kFirst>
__device__ void merge_level(const uint32_t* sk, const uint16_t* src, uint16_t* dst,
                            const int* off, int k, int gs, int x, int x1) {
  int pj = segment_of(off, k, x) & ~(2 * gs - 1);
  int a0 = off[pj], a1 = off[min(pj + gs, k)], b1 = off[min(pj + 2 * gs, k)];
  int na = a1 - a0, nb = b1 - a1;
  // Merge path: the A rows among the first d outputs of the pair.
  int d = x - a0;
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    Key ka = key_at(sk, row_at<kFirst>(src, a0 + mid));
    Key kb = key_at(sk, row_at<kFirst>(src, a1 + d - mid - 1));
    if (!key_lt(kb, ka)) lo = mid + 1; else hi = mid;
  }
  int i = lo, j = d - lo, ra = 0, rb = 0;
  Key ka{0, 0, 0}, kb{0, 0, 0};
  if (i < na) ka = key_at(sk, ra = row_at<kFirst>(src, a0 + i));
  if (j < nb) kb = key_at(sk, rb = row_at<kFirst>(src, a1 + j));
  for (; x < x1; ++x) {
    while (x == b1) {  // the next pair starts here
      pj += 2 * gs;
      a0 = b1;
      a1 = off[min(pj + gs, k)];
      b1 = off[min(pj + 2 * gs, k)];
      na = a1 - a0;
      nb = b1 - a1;
      i = j = 0;
      if (na) ka = key_at(sk, ra = row_at<kFirst>(src, a0));
      if (nb) kb = key_at(sk, rb = row_at<kFirst>(src, a1));
    }
    if (i < na && (j >= nb || !key_lt(kb, ka))) {
      dst[x] = (uint16_t)ra;
      if (++i < na) ka = key_at(sk, ra = row_at<kFirst>(src, a0 + i));
    } else {
      dst[x] = (uint16_t)rb;
      if (++j < nb) kb = key_at(sk, rb = row_at<kFirst>(src, a1 + j));
    }
  }
}

// The stack row of tile row r: row beg[j] + r - off[j] of run j.
__device__ __forceinline__ long long stack_row(const int* off, const int* beg, int k, int b,
                                               int r) {
  int j = segment_of(off, k, r);
  return (long long)j * b + beg[j] + (r - off[j]);
}

// A tile's first output row, and thread t's run's segment of it [c0, c1)
// (for t < k), from the co-ranks of the samples the tile starts and ends
// at (the end of the stack for the last tile).
struct TileMeta {
  long long out0;
  int c0, c1;
};

__device__ __forceinline__ TileMeta tile_meta(const Args& a, int tile) {
  TileMeta m{0, 0, 0};
  if (tile >= a.ntiles) return m;
  const int t = threadIdx.x;
  m.out0 = __ldcg(a.tile_rank + tile);
  if (t < a.k) {
    int id_s = __ldcg(a.tile_sample + tile);
    int id_e = tile + 1 < a.ntiles ? __ldcg(a.tile_sample + tile + 1) : -1;
    m.c0 = __ldcg(a.co + (long long)id_s * a.k + t);
    m.c1 = id_e < 0 ? a.b : __ldcg(a.co + (long long)id_e * a.k + t);
  }
  return m;
}

// Phase 3: one tile, by the whole block. Blocks take tiles from a queue,
// so the SMs finish together whatever the tiles' sizes; the next tile's
// metadata loads while this one merges. Returns the next tile.
__device__ int merge_tile(const Args& a, TileMeta& meta, uint32_t* sk, uint16_t* ord0,
                          uint16_t* ord1, int* beg, int* off) {
  const int t = threadIdx.x, k = a.k;
  if (t == 0) s_next = atomicAdd(a.next_tile, 1);
  const long long out0 = meta.out0;
  int len = 0;
  if (t < k) {
    beg[t] = meta.c0;
    len = meta.c1 - meta.c0;
  }
  int excl = block_excl_sum(len);
  if (t < k) off[t] = excl;
  if (t == k - 1) off[k] = excl + len;
  __syncthreads();
  const int rows = off[k];
  if (rows > kTileMax) __trap();  // the sampling bound does not hold
  const int next = s_next;

  // The k segments' keys into shared memory.
  for (int r = t; r < rows; r += kThreads) {
    long long src = 3 * stack_row(off, beg, k, a.b, r);
#pragma unroll
    for (int w = 0; w < 3; ++w) copy_word(sk + 3 * r + w, a.keys + src + w);
  }
  meta = tile_meta(a, next);
  copy_wait();

  // The pairwise tree: at level gs, groups of gs segments (each already
  // merged) merge in pairs, the older group first at equal keys. Level 1
  // reads the tile's rows in their own order.
  uint16_t* src = ord0;
  uint16_t* dst = ord1;
  const int per = (rows + kThreads - 1) / kThreads;
  for (int gs = 1; gs < k; gs <<= 1) {
    int x = t * per, x1 = min(x + per, rows);
    if (x < x1) {
      if (gs == 1) merge_level<true>(sk, src, dst, off, k, gs, x, x1);
      else merge_level<false>(sk, src, dst, off, k, gs, x, x1);
    }
    __syncthreads();
    uint16_t* tmp = src;
    src = dst;
    dst = tmp;
  }

  // The keys in output order, word by word; then the payloads take the
  // keys' place, and go out in the same order.
  uint32_t* ok = a.out_keys + 3 * out0;
  for (int w = t; w < 3 * rows; w += kThreads) {
    int r = w / 3, c = w - 3 * r;
    ok[w] = sk[3 * src[r] + c];
  }
  __syncthreads();
  for (int r = t; r < rows; r += kThreads) {
    long long from = 3 * stack_row(off, beg, k, a.b, r);
#pragma unroll
    for (int w = 0; w < 3; ++w) copy_word(sk + 3 * r + w, a.pays + from + w);
  }
  copy_wait();
  uint32_t* op = a.out_pays + 3 * out0;
  for (int w = t; w < 3 * rows; w += kThreads) {
    int r = w / 3, c = w - 3 * r;
    op[w] = sk[3 * src[r] + c];
  }
  __syncthreads();
  return next;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) fold(Args a) {
  extern __shared__ uint32_t smem[];
  uint32_t* sk = smem;
  uint16_t* ord0 = reinterpret_cast<uint16_t*>(sk + 3 * kTileMax);
  uint16_t* ord1 = ord0 + kTileMax;
  int* beg = reinterpret_cast<int*>(ord1 + kTileMax);
  int* off = beg + kMaxRuns;
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.next_tile = gridDim.x;
  rank_samples(a, sk);
  grid.sync();
  split_tiles(a);
  grid.sync();
  TileMeta meta = tile_meta(a, blockIdx.x);
  for (int tile = blockIdx.x; tile < a.ntiles;) {
    tile = merge_tile(a, meta, sk, ord0, ord1, beg, off);
  }
}

bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

// The sample stride, the sample count and the tile count of a (k, b) fold.
struct Shape {
  long long s, ns, ntiles;
};

Shape shape_of(long long k, long long b) {
  long long s = kSlack / k;
  if (s < 1) s = 1;
  if (s > b) s = b;
  return {s, k * (b / s), (k * b + kTile - 1) / kTile};
}

struct Launch {
  bool ready = false;
  int blocks = 0;  // co-resident blocks on the device
};
Launch g_launch[64];

}  // namespace

// Bytes of scratch the fold of a (k, b) stack needs (the samples' co-ranks
// and places, and the tiles' splits), or -1 for a shape it does not take.
extern "C" long long tb_compact_fold_scratch(long long k, long long b) {
  if (!pow2(k) || k < 2 || k > kMaxRuns || !pow2(b) || b < 256 || k * b >= (1ll << 31)) {
    return -1;
  }
  Shape sh = shape_of(k, b);
  return 4 * (sh.ns * (k + 2) + 2 * sh.ntiles + 1);
}

// keys, pays (k, b, 3) -> out_keys, out_pays (k b, 3), all uint32 and
// contiguous; scratch: tb_compact_fold_scratch(k, b) bytes.
extern "C" int tb_compact_fold(const void* keys, const void* pays, void* out_keys,
                               void* out_pays, void* scratch, long long k, long long b,
                               void* stream) {
  if (tb_compact_fold_scratch(k, b) < 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  Launch& l = g_launch[dev];
  if (!l.ready) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(fold, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fold, kThreads, kSmem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    l.blocks = sms * per_sm;
    l.ready = true;
  }
  Shape sh = shape_of(k, b);
  int* ints = static_cast<int*>(scratch);
  // Phase 1's table: up to 64 rows a run, as many as a tile's keys' space
  // holds.
  int table = b < 64 ? (int)b : 64;
  while (table > 1 && k * (table + 1) > kTileMax) table /= 2;
  Args a{(const uint32_t*)keys, (const uint32_t*)pays, (uint32_t*)out_keys,
         (uint32_t*)out_pays, ints, ints + sh.ns * k, ints + sh.ns * (k + 1),
         ints + sh.ns * (k + 2), ints + sh.ns * (k + 2) + sh.ntiles,
         ints + sh.ns * (k + 2) + 2 * sh.ntiles, (int)k, (int)b, (int)sh.s, (int)sh.ns,
         (int)sh.ntiles, table};
  // Enough blocks for the tiles and for a lane group a sample.
  long long lanes = sh.ns * (k < 32 ? k : 32);
  long long want = sh.ntiles > (lanes + kThreads - 1) / kThreads
                       ? sh.ntiles
                       : (lanes + kThreads - 1) / kThreads;
  int grid = (int)(want < l.blocks ? want : l.blocks);
  void* kargs[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)fold, dim3(grid), dim3(kThreads), kargs, kSmem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
