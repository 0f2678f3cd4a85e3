// Greedy non-maximum suppression over score-sorted boxes, for sm_90a.
//
// Replaces no TPU kernel: the JAX package's box_nms
// (mxnet_tpu/ops/contrib.py:41, also under MultiBoxDetection :280 and
// the RPN's _proposal_single :339) is a lax.fori_loop of N steps over an
// N x N IoU matrix per image, which XLA keeps on the chip.  Greedy NMS
// is a chain: row i, when valid and not removed by a kept earlier row,
// removes every later row of its class whose IoU with it exceeds the
// threshold.  Three facts make the chain short on the card:
//
//   * With class ids it splits exactly into one independent chain per
//     class (rows of two classes never touch), each in score order.
//     Invalid rows neither survive nor suppress, so they leave it.
//   * Walk the chain 64 rows (a block) at a time.  Whether an earlier
//     block removes a row of block c is an OR over the kept rows of
//     the earlier blocks of their words for block c: with the bit
//     matrix stored a 64 x 64 tile at a time, column block after column
//     block, those words are one contiguous run, fetched ahead of the
//     chain and reduced by every thread at once.
//   * Inside a block the chain resolves from the 64 "column words" (bit
//     i of word j: earlier row i would remove row j) by a fixed-point
//     iteration on one warp's ballots: after t rounds the first t rows
//     are final, and a round that changes nothing has reached the
//     greedy answer.  No step of the chain reads device memory.
//
// Two routes, chosen by N alone (the binding's nms_route):
//
//   fused (N <= kFusedMax = 1024): one launch, a cluster of kFusedCluster
//     blocks (SMs) an image.  Every block holds the boxes and computes
//     its share of the bit matrix (row words above the diagonal, column
//     words on it; class checked pair by pair) into the first block's
//     shared memory, which then sweeps alone (at most ~190 KB at
//     N = 1024 in float64).
//   tiled (N > kFusedMax): three launches.
//     1. nms_group: one block an image groups its valid rows, stably,
//        into segments by a hash of the class id (256 buckets; two
//        classes that share a bucket share a segment and are told apart
//        by the id compare), with the boxes gathered in segment order.
//     2. nms_mask: blocks over the 64 x 64 tiles on and above each
//        segment's diagonal, in every image, each written as 64
//        consecutive words (rows' words above the diagonal, column words
//        on it).  No other word is computed or written.
//     3. nms_sweep: one block a segment walks it a block at a time;
//        each column block's tiles (up to kWindow of them, the diagonal
//        tile last) arrive in shared memory by one 1-D bulk copy (TMA)
//        into a three-stage ring, fetched three blocks ahead; tiles of
//        rows further back are read from device memory directly.
//
// Bounds on an H100: the IoU tests of the pairs of one class (about 12
// operations each, against 67 TFLOP/s in float32, 34 in float64) and
// the boxes' bytes; the sweep is a chain of N/64 steps a segment.  The
// IoU is computed with the round-to-nearest intrinsics (no fused
// multiply-add) so that every bit matches the plain version's
// element-wise PyTorch ops, and the keep masks agree exactly; a pair
// that does not overlap skips the division, and float64 divides only
// where a float32 quotient cannot tell the side of the threshold.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <atomic>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;
constexpr int kFusedMax = 1024;      // N of the fused route, at most
constexpr int kFusedThreads = 512;
constexpr int kFusedCluster = 4;     // blocks (SMs) an image on the fused route
constexpr int kBuckets = 256;        // segments an image, at most
constexpr int kGroupThreads = 1024;  // its first kBuckets: a thread a bucket
constexpr int kGroupWarps = kGroupThreads / 32;
static_assert(kBuckets == 256, "nms_group scans the buckets on 8 warps");
constexpr int kSweepThreads = 512;
constexpr int kWindow = 96;          // tiles a ring stage holds
constexpr int kStages = 3;
// dynamic shared memory a block may take: 227 KB less room for the
// kernels' few static bytes
constexpr size_t kSmemMax = 232448 - 1024;

// One segment of an image's grouped rows: rows [start, start + n) of
// the grouped order; its tiles are numbered from `toff` within the
// image, and tile t of the image is words [64 t, 64 t + 64) of its mask.
struct Seg {
  int start, n, toff;
};

__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double rn_div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return ::fmax(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return ::fmin(a, b); }

// A box in registers: its corners and its area (computed once a box,
// as the plain version's `area`).
template <typename T>
struct Box {
  T x0, y0, x1, y1, area;
};

template <typename T>
__device__ __forceinline__ T box_area(T x0, T y0, T x1, T y1) {
  const T zero = T(0);
  return rn_mul(vmax(rn_sub(x1, x0), zero), vmax(rn_sub(y1, y0), zero));
}

template <typename T>
__device__ __forceinline__ Box<T> load_box(const T* p, const T* area) {
  return Box<T>{p[0], p[1], p[2], p[3], *area};
}

// rn(inter / uni) > t, exactly as the plain version's division and
// compare.  float64 decides in float32 where the quotient is clearly
// off the threshold: the float32 quotient of the float32-rounded
// operands is within 2e-7 of the true one relatively (all in float32's
// normal range), against a margin of 8e-7; the rest divide in float64.
__device__ __forceinline__ bool above(float inter, float uni, float t) {
  return rn_div(inter, uni) > t;
}
__device__ __forceinline__ bool above(double inter, double uni, double t) {
  const float fi = (float)inter, fu = (float)uni, tf = (float)t;
  if (tf > 1e-30f && tf < 1e30f && fi > 1e-30f && fi < 1e30f &&
      fu > 1e-30f && fu < 1e30f) {
    const float q = __fdiv_rn(fi, fu);
    if (q > __fmul_rn(tf, 1.000001f)) return true;
    if (q < __fmul_rn(tf, 0.999999f)) return false;
  }
  return rn_div(inter, uni) > t;
}

// Whether the earlier box `a` removes the later box `b`: ops/contrib.py
// _box_iou_corner, operation for operation, then "> thresh".  A pair
// that does not overlap has IoU 0 (or NaN), never above a threshold >= 0
// (`cut`): it skips the rest.
template <typename T>
__device__ __forceinline__ bool over(const Box<T>& a, const Box<T>& b,
                                     T thresh, bool cut) {
  const T zero = T(0);
  const T w = vmax(rn_sub(vmin(a.x1, b.x1), vmax(a.x0, b.x0)), zero);
  const T h = vmax(rn_sub(vmin(a.y1, b.y1), vmax(a.y0, b.y0)), zero);
  const T inter = rn_mul(w, h);
  if (cut && inter == zero) return false;
  const T uni = vmax(rn_sub(rn_add(a.area, b.area), inter), T(1e-12));
  return above(inter, uni, thresh);
}

// The bits of columns k in [k0, cn) of a 64-column tile that row `me`
// removes: valid (where `cval` is given), of the row's class (where
// `cid` is given: ids compared as floats), IoU above the threshold.
// With `Screen`, a first pass over the tile keeps the candidates: those
// checks, and not shown apart by the float32 copies of the corners
// (rounding to float32 keeps order, so float32 corners that leave no
// overlap mean the exact ones leave none either: IoU 0); the exact test
// then runs on each lane's candidates alone, so a warp pays for the
// pairs its busiest lane tests instead of every pair some lane tests.
// That wins where the exact test is dear (float64) or the class check
// leaves few pairs (ids in one block, the fused route).
template <bool Screen, typename T>
__device__ __forceinline__ uint64_t row_bits(
    const Box<T>& me, float4 me32, T my, const T* cbox, const T* carea,
    const float4* c32, const T* cid, const uint8_t* cval, int k0, int cn,
    T thresh, bool cut) {
  if (!Screen) {
    uint64_t bits = 0;
    for (int k = k0; k < cn; ++k) {
      // float32: the copies are the corners themselves, one 16-byte load
      const float4 c = c32[k];
      const Box<T> other =
          sizeof(T) == 4 ? Box<T>{T(c.x), T(c.y), T(c.z), T(c.w), carea[k]}
                         : load_box(cbox + 4 * k, carea + k);
      if ((!cid || cid[k] == my) && (!cval || cval[k]) &&
          over(me, other, thresh, cut))
        bits |= 1ull << k;
    }
    return bits;
  }
  // no branch in this pass: every load of a column is issued before any
  // of them is tested
  uint64_t cand = 0;
  const bool use_id = cid != nullptr, use_val = cval != nullptr;
#pragma unroll 4
  for (int k = k0; k < cn; ++k) {
    const float4 c = c32[k];
    const T ck = use_id ? cid[k] : my;
    const bool vk = use_val ? cval[k] != 0 : true;
    const bool apart = (fminf(me32.z, c.z) < fmaxf(me32.x, c.x)) |
                       (fminf(me32.w, c.w) < fmaxf(me32.y, c.y));
    cand |= (uint64_t)(!(cut & apart) & (ck == my) & vk) << k;
  }
  uint64_t bits = 0;
  while (cand) {
    const int k = __ffsll((long long)cand) - 1;
    cand &= cand - 1;
    if (over(me, load_box(cbox + 4 * k, carea + k), thresh, cut))
      bits |= 1ull << k;
  }
  return bits;
}

template <typename T>
__device__ __forceinline__ float4 corners32(const T* p) {
  return make_float4((float)p[0], (float)p[1], (float)p[2], (float)p[3]);
}

// The segment bucket of a class id: a mix of its bits (+0 for -0, the
// ids being compared as floats).
__device__ __forceinline__ int bucket(float x) {
  uint32_t u = __float_as_uint(x == 0.0f ? 0.0f : x);
  u ^= u >> 16;
  u *= 0x85ebca6bu;
  u ^= u >> 13;
  u *= 0xc2b2ae35u;
  u ^= u >> 16;
  return (int)(u & (kBuckets - 1));
}
__device__ __forceinline__ int bucket(double x) {
  uint64_t u = (uint64_t)__double_as_longlong(x == 0.0 ? 0.0 : x);
  u ^= u >> 33;
  u *= 0xff51afd7ed558ccdull;
  u ^= u >> 33;
  u *= 0xc4ceb9fe1a85ec53ull;
  u ^= u >> 33;
  return (int)(u & (kBuckets - 1));
}

// Warp-wide: the kept rows of one 64-row block.  `alive` has the rows
// that are valid and not removed by earlier blocks; lane l holds the
// column words of rows l (c0) and l + 32 (c1).  Iterates "row j is kept
// iff alive and no kept earlier row of the block removes it" to its
// fixed point: after t rounds the first t rows are final, so it ends
// within 65 rounds, and the fixed point is the greedy answer.  A round
// is two ballots; the rounds a block takes are the longest chain of
// rows in it whose fate waits on the row before.
__device__ __forceinline__ uint64_t resolve(uint64_t alive, uint64_t c0,
                                            uint64_t c1, int lane) {
  const bool a0 = (alive >> lane) & 1ull, a1 = (alive >> (lane + 32)) & 1ull;
  uint64_t k = alive;
  for (;;) {
    const uint32_t lo = __ballot_sync(0xffffffffu, a0 && !(c0 & k));
    const uint32_t hi = __ballot_sync(0xffffffffu, a1 && !(c1 & k));
    const uint64_t k2 = ((uint64_t)hi << 32) | lo;
    if (k2 == k) return k;
    k = k2;
  }
}

// Block-wide: the words of column block cb that the kept rows of the
// blocks before it hold, ORed together.  Row j's word is far[j * stride]
// for j < first and near[(j - first) * stride] after; kept[j / 64] holds
// the kept rows of block j / 64.  Every thread ORs a strided share of
// the rows, masked by their kept bits (no branch between the loads);
// the warps' results meet in `part`.  Returns the OR in warp 0, after a
// barrier inside.
__device__ __forceinline__ uint64_t removed_by_earlier(
    int cb, const uint64_t* kept, uint64_t* part, const uint64_t* far,
    const uint64_t* near, int first, int stride) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5, end = cb * kTile;
  const int split = min(first, end);
  uint64_t acc = 0;
  for (int j = tid; j < split; j += blockDim.x)
    acc |= far[(size_t)j * stride] & (0ull - ((kept[j >> 6] >> (j & 63)) & 1ull));
#pragma unroll 4
  for (int j = split + tid; j < end; j += blockDim.x)
    acc |= near[(size_t)(j - first) * stride] &
           (0ull - ((kept[j >> 6] >> (j & 63)) & 1ull));
  const uint32_t lo = __reduce_or_sync(0xffffffffu, (uint32_t)acc);
  const uint32_t hi = __reduce_or_sync(0xffffffffu, (uint32_t)(acc >> 32));
  if (lane == 0) part[warp] = ((uint64_t)hi << 32) | lo;
  __syncthreads();
  uint64_t r = 0;
  if (warp == 0) {
    const uint64_t p = lane < nwarps ? part[lane] : 0ull;
    r = ((uint64_t)__reduce_or_sync(0xffffffffu, (uint32_t)(p >> 32)) << 32) |
        __reduce_or_sync(0xffffffffu, (uint32_t)p);
  }
  return r;
}

// ---------------------------------------------------------------------------
// the fused route: a cluster an image, everything in shared memory
// ---------------------------------------------------------------------------
template <typename T>
size_t fused_smem(int n, bool ids) {
  const size_t words = (size_t)(n + kTile - 1) / kTile;
  return (size_t)n * 16 + (size_t)n * words * 8 + words * 8 +
         (size_t)n * 5 * sizeof(T) + (ids ? (size_t)n * sizeof(T) : 0) +
         (size_t)n;
}

// grid (B * kFusedCluster), clusters of kFusedCluster blocks, an image
// a cluster: every block holds the image's boxes and computes its share
// of the bit matrix into the shared memory of the cluster's first
// block, which then sweeps alone
template <typename T>
__global__ void __cluster_dims__(kFusedCluster, 1, 1)
__launch_bounds__(kFusedThreads)
nms_fused(const T* __restrict__ boxes, const T* __restrict__ ids,
          const uint8_t* __restrict__ valid, int n, T thresh,
          uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t part[kFusedThreads / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kFusedCluster, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int words = (n + kTile - 1) / kTile;
  float4* s32 = reinterpret_cast<float4*>(smem);          // n
  uint64_t* mask = reinterpret_cast<uint64_t*>(s32 + n);  // n x words
  uint64_t* kept = mask + (size_t)n * words;              // words
  T* sbox = reinterpret_cast<T*>(kept + words);           // n x 4
  T* sarea = sbox + 4 * n;                                // n
  T* sid = ids ? sarea + n : nullptr;                     // n, with ids
  uint8_t* sval = reinterpret_cast<uint8_t*>(sarea + n + (ids ? n : 0));
  const size_t base = (size_t)b * n;
  for (int k = tid; k < 4 * n; k += blockDim.x) sbox[k] = boxes[base * 4 + k];
  if (ids)
    for (int k = tid; k < n; k += blockDim.x) sid[k] = ids[base + k];
  for (int k = tid; k < n; k += blockDim.x) sval[k] = valid[base + k];
  if (rank == 0)  // the diagonal words gather column halves by atomicOr
    for (int k = tid; k < n; k += blockDim.x) mask[(size_t)k * words + k / kTile] = 0ull;
  __syncthreads();
  for (int k = tid; k < n; k += blockDim.x) {
    const T* p = sbox + 4 * k;
    sarea[k] = box_area(p[0], p[1], p[2], p[3]);
    s32[k] = corners32(p);
  }
  cluster.sync();  // every block's boxes ready, the first's words zero
  uint64_t* mask0 = cluster.map_shared_rank(mask, 0);

  // a warp a job (32 rows from g*32, word w), a lane a row: above the
  // diagonal (w > g/2) the row's word w, the later rows it removes; on
  // it the row's bits against its block's later rows, turned by ballots
  // into the column words (the earlier rows that remove a row)
  const bool cut = thresh >= T(0);
  const bool screen = ids || sizeof(T) == 8;
  const int halves = (n + 31) / 32;
  int njobs = 0;
  for (int g = 0; g < halves; ++g) njobs += words - g / 2;
  for (int job = rank * nwarps + warp; job < njobs;
       job += nwarps * kFusedCluster) {
    int g = 0, w = job;
    while (w >= words - g / 2) {
      w -= words - g / 2;
      ++g;
    }
    const int i = g * 32 + lane, ib = g / 2;
    w += ib;
    const int c0 = w * kTile, cn = min(kTile, n - c0);
    uint64_t bits = 0;
    if (i < n && sval[i]) {
      const Box<T> me = load_box(sbox + 4 * i, sarea + i);
      const T my = ids ? sid[i] : T(0);
      const int k0 = w == ib ? (i & 63) + 1 : 0;
      const T* cid = sid ? sid + c0 : nullptr;
      bits = screen ? row_bits<true>(me, s32[i], my, sbox + 4 * c0, sarea + c0,
                                     s32 + c0, cid, sval + c0, k0, cn, thresh, cut)
                    : row_bits<false>(me, s32[i], my, sbox + 4 * c0, sarea + c0,
                                      s32 + c0, cid, sval + c0, k0, cn, thresh, cut);
    }
    if (w > ib) {
      if (i < n) mask0[(size_t)i * words + w] = bits;
      continue;
    }
    uint32_t col0 = 0u, col1 = 0u;  // columns lane and lane + 32
    for (int k = 0; k < cn; ++k) {
      const uint32_t col = __ballot_sync(0xffffffffu, (bits >> k) & 1ull);
      if (lane == (k & 31)) {
        if (k < 32) col0 = col; else col1 = col;
      }
    }
    // rows g*32.. are the low (g even) or high half of the column words
    if (col0)
      atomicOr(reinterpret_cast<unsigned*>(&mask0[(size_t)(c0 + lane) * words + w]) +
                   (g & 1), col0);
    if (col1)
      atomicOr(reinterpret_cast<unsigned*>(
                   &mask0[(size_t)(c0 + lane + 32) * words + w]) + (g & 1), col1);
  }
  cluster.sync();  // the whole bit matrix is in the first block
  if (rank != 0) return;

  for (int cb = 0; cb < words; ++cb) {
    const int r0 = cb * kTile, rows = min(kTile, n - r0);
    const uint64_t gone =
        removed_by_earlier(cb, kept, part, mask + cb, mask + cb, 0, words);
    if (warp == 0) {
      const bool v0 = lane < rows && sval[r0 + lane];
      const bool v1 = lane + 32 < rows && sval[r0 + lane + 32];
      const uint64_t va = ((uint64_t)__ballot_sync(0xffffffffu, v1) << 32) |
                          __ballot_sync(0xffffffffu, v0);
      const uint64_t c0 = lane < rows ? mask[(size_t)(r0 + lane) * words + cb] : 0;
      const uint64_t c1 =
          lane + 32 < rows ? mask[(size_t)(r0 + lane + 32) * words + cb] : 0;
      const uint64_t k = resolve(va & ~gone, c0, c1, lane);
      if (lane == 0) kept[cb] = k;
      if (lane < rows) keep[base + r0 + lane] = (uint8_t)((k >> lane) & 1ull);
      if (lane + 32 < rows)
        keep[base + r0 + lane + 32] = (uint8_t)((k >> (lane + 32)) & 1ull);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the tiled route
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ int row_bucket(const T* ids, const uint8_t* valid,
                                          size_t base, int r, int hi) {
  if (r >= hi || !valid[base + r]) return -1;
  return ids ? bucket(ids[base + r]) : 0;
}

// grid (B), kGroupThreads: group image b's valid rows into segments by
// bucket, stably; write the segment table, the grouped boxes / ids /
// original row indices, and keep = 0 for the invalid rows
template <typename T>
__global__ void __launch_bounds__(kGroupThreads)
nms_group(const T* __restrict__ boxes, const T* __restrict__ ids,
          const uint8_t* __restrict__ valid, int n, T* __restrict__ gbox,
          T* __restrict__ gid, int* __restrict__ gidx, Seg* __restrict__ segs,
          int* __restrict__ counts, uint8_t* __restrict__ keep) {
  __shared__ int cnt[kGroupWarps][kBuckets];  // a warp's rows a bucket
  __shared__ int bstart[kBuckets];
  __shared__ int s_rows[8], s_segs[8], s_tiles[8];
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5,
            lane = tid & 31;
  const size_t base = (size_t)b * n;
  // each warp owns a contiguous chunk of rows, a multiple of 32
  const int per = ((n + kGroupWarps - 1) / kGroupWarps + 31) & ~31;
  const int lo = min(n, warp * per), hi = min(n, lo + per);
  for (int k = tid; k < kGroupWarps * kBuckets; k += blockDim.x)
    cnt[k / kBuckets][k % kBuckets] = 0;
  __syncthreads();
  // each warp counts its chunk's valid rows by bucket; the next 32
  // rows' loads are in flight while the current ones are counted
  int next = row_bucket(ids, valid, base, lo + lane, hi);
  for (int r0 = lo; r0 < hi; r0 += 32) {
    const int bk = next;
    if (r0 + 32 < hi) next = row_bucket(ids, valid, base, r0 + 32 + lane, hi);
    if (bk < 0 && r0 + lane < hi) keep[base + r0 + lane] = 0;
    const unsigned peers = __match_any_sync(0xffffffffu, bk);
    if (bk >= 0 && lane == __ffs(peers) - 1) cnt[warp][bk] += __popc(peers);
  }
  __syncthreads();
  // thread tid < kBuckets: bucket tid, each warp's first row within it
  // and its total; the segments are the non-empty buckets in bucket
  // order: a scan of (rows, segments, tiles) over them
  if (tid < kBuckets) {
    int total = 0;
    for (int w = 0; w < kGroupWarps; ++w) {
      const int c = cnt[w][tid];
      cnt[w][tid] = total;
      total += c;
    }
    const int wds = (total + kTile - 1) / kTile;
    const int tiles = wds * (wds + 1) / 2;
    int x_rows = total, x_segs = total > 0, x_tiles = tiles;
    for (int d = 1; d < 32; d <<= 1) {  // inclusive, within the warp
      const int a = __shfl_up_sync(0xffffffffu, x_rows, d);
      const int c = __shfl_up_sync(0xffffffffu, x_segs, d);
      const int e = __shfl_up_sync(0xffffffffu, x_tiles, d);
      if (lane >= d) {
        x_rows += a;
        x_segs += c;
        x_tiles += e;
      }
    }
    if (lane == 31) {
      s_rows[warp] = x_rows;
      s_segs[warp] = x_segs;
      s_tiles[warp] = x_tiles;
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kBuckets));  // the bucket warps
    for (int w = 0; w < warp; ++w) {
      x_rows += s_rows[w];
      x_segs += s_segs[w];
      x_tiles += s_tiles[w];
    }
    bstart[tid] = x_rows - total;
    if (total > 0)
      segs[(size_t)b * kBuckets + (x_segs - 1)] =
          Seg{x_rows - total, total, x_tiles - tiles};
    if (tid == kBuckets - 1) {
      counts[2 * b] = x_segs;
      counts[2 * b + 1] = x_tiles;
    }
  }
  __syncthreads();
  // the stable scatter: each warp walks its chunk again in row order
  next = row_bucket(ids, valid, base, lo + lane, hi);
  for (int r0 = lo; r0 < hi; r0 += 32) {
    const int r = r0 + lane, bk = next;
    if (r0 + 32 < hi) next = row_bucket(ids, valid, base, r0 + 32 + lane, hi);
    const unsigned peers = __match_any_sync(0xffffffffu, bk);
    int p = 0;
    if (bk >= 0)
      p = bstart[bk] + cnt[warp][bk] + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
    if (bk >= 0 && lane == __ffs(peers) - 1) cnt[warp][bk] += __popc(peers);
    __syncwarp();
    if (bk >= 0) {
      gidx[base + p] = r;
#pragma unroll
      for (int k = 0; k < 4; ++k) gbox[(base + p) * 4 + k] = boxes[(base + r) * 4 + k];
      if (ids) gid[base + p] = ids[base + r];
    }
  }
}

// grid (X, B), kTile threads: tiles t = blockIdx.x, + gridDim.x, ... of
// image b.  Tile u of a segment is (rb, cb), rb <= cb, u = cb(cb+1)/2 +
// rb: the tiles of column block cb one run, the diagonal tile last.
// Thread tid owns row rb*64 + tid and writes its word for column block
// cb, or on the diagonal the column word of row cb*64 + tid.
template <typename T>
__global__ void __launch_bounds__(kTile)
nms_mask(const T* __restrict__ gbox, const T* __restrict__ gid,
         const Seg* __restrict__ segs, const int* __restrict__ counts, int n,
         long long mstride, T thresh, uint64_t* __restrict__ mask) {
  __shared__ T cbox[kTile * 4];
  __shared__ T carea[kTile];
  __shared__ T cid[kTile];
  __shared__ float4 c32[kTile];
  __shared__ uint64_t rw[kTile];
  __shared__ int toff[kBuckets];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int nseg = counts[2 * b], ntiles = counts[2 * b + 1];
  if ((int)blockIdx.x >= ntiles) return;
  const Seg* sg = segs + (size_t)b * kBuckets;
  for (int k = tid; k < nseg; k += blockDim.x) toff[k] = sg[k].toff;
  __syncthreads();
  const size_t base = (size_t)b * n;
  const bool cut = thresh >= T(0);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int lo = 0, hi = nseg - 1;  // the last segment whose tiles start <= t
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (toff[mid] <= t) lo = mid; else hi = mid - 1;
    }
    const Seg s = sg[lo];
    const int u = t - s.toff;
    int cb = (int)((sqrt(8.0 * u + 1.0) - 1.0) * 0.5);
    while ((cb + 1) * (cb + 2) / 2 <= u) ++cb;
    while (cb * (cb + 1) / 2 > u) --cb;
    const int rb = u - cb * (cb + 1) / 2;
    const int c0 = cb * kTile, cn = min(kTile, s.n - c0);
    const size_t sbase = base + s.start;
    __syncthreads();  // the previous tile's reads of the shared arrays
    if (tid < cn) {
      T* c = cbox + 4 * tid;
#pragma unroll
      for (int k = 0; k < 4; ++k) c[k] = gbox[(sbase + c0 + tid) * 4 + k];
      carea[tid] = box_area(c[0], c[1], c[2], c[3]);
      c32[tid] = corners32(c);
      if (gid) cid[tid] = gid[sbase + c0 + tid];
    }
    __syncthreads();
    const int i = rb * kTile + tid;
    const T my = gid && i < s.n ? gid[sbase + i] : T(0);
    // a segment is one class but where two share a bucket: a tile whose
    // rows and columns all hold the first column's id skips the compare
    const bool one_class = __syncthreads_and(
        !gid || ((i >= s.n || my == cid[0]) && (tid >= cn || cid[tid] == cid[0])));
    uint64_t bits = 0;
    if (i < s.n) {
      T m[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) m[k] = gbox[(sbase + i) * 4 + k];
      const Box<T> me{m[0], m[1], m[2], m[3], box_area(m[0], m[1], m[2], m[3])};
      // float32 tests every pair directly, float64 screens first
      bits = row_bits<sizeof(T) == 8>(
          me, corners32(m), my, cbox, carea, c32, one_class ? nullptr : cid,
          nullptr, rb == cb ? tid + 1 : 0, cn, thresh, cut);
    }
    uint64_t* tile = mask + b * mstride + (long long)t * kTile;
    if (rb != cb) {
      tile[tid] = bits;
    } else {
      rw[tid] = bits;
      __syncthreads();
      uint64_t col = 0;  // the column word of row i
      for (int r = 0; r < tid; ++r) col |= ((rw[r] >> tid) & 1ull) << r;
      tile[tid] = col;
    }
  }
}

size_t sweep_smem(int wmax) {
  return (size_t)kStages * kWindow * kTile * 8 + (size_t)wmax * 8;
}

// grid (X, B), kSweepThreads: segments blockIdx.x, + gridDim.x, ... of
// image b, each walked a block at a time
__global__ void __launch_bounds__(kSweepThreads)
nms_sweep(const Seg* __restrict__ segs, const int* __restrict__ counts,
          const int* __restrict__ gidx, int n, long long mstride,
          const uint64_t* __restrict__ mask, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(128) uint64_t sm[];
  __shared__ __align__(8) uint64_t bars[kStages];
  __shared__ uint64_t part[kSweepThreads / 32];
  uint64_t* ring = sm;                                 // kStages x kWindow tiles
  uint64_t* kept = sm + kStages * kWindow * kTile;     // a segment's blocks
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int nseg = counts[2 * b];
  if ((int)blockIdx.x >= nseg) return;
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) wg::mbar_init(wg::smem_addr(&bars[st]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const size_t base = (size_t)b * n;
  uint32_t phase = 0;  // bit st: the parity stage st waits for next
  for (int si = blockIdx.x; si < nseg; si += gridDim.x) {
    const Seg s = segs[(size_t)b * kBuckets + si];
    const uint64_t* m = mask + b * mstride + (long long)s.toff * kTile;
    const int* gi = gidx + base + s.start;
    const int words = (s.n + kTile - 1) / kTile;
    // thread 0: fetch the last min(cb + 1, kWindow) tiles of column
    // block cb (the diagonal tile last) into stage st
    auto fetch = [&](int st, int cb) {
      const int nt = min(cb + 1, kWindow);
      const uint32_t bytes = (uint32_t)nt * kTile * 8u;
      const uint32_t bar = wg::smem_addr(&bars[st]);
      wg::mbar_expect_tx(bar, bytes);
      wg::bulk_load(wg::smem_addr(ring + (size_t)st * kWindow * kTile),
                    m + ((size_t)cb * (cb + 1) / 2 + (cb + 1 - nt)) * kTile,
                    bytes, bar);
    };
    if (tid == 0)
      for (int st = 0; st < kStages && st < words; ++st) fetch(st, st);
    // warp 0 holds the original row indices of the block it resolves,
    // loaded a block ahead
    int g0 = -1, g1 = -1;
    if (tid < 32) {
      g0 = lane < s.n ? gi[lane] : -1;
      g1 = lane + 32 < s.n ? gi[lane + 32] : -1;
    }
    for (int cb = 0; cb < words; ++cb) {
      const int st = cb % kStages;
      wg::mbar_wait(wg::smem_addr(&bars[st]), (phase >> st) & 1u);
      phase ^= 1u << st;
      const uint64_t* run = ring + (size_t)st * kWindow * kTile;
      const int r0 = cb * kTile, rows = min(kTile, s.n - r0);
      // row j's word is run[j - first] where the ring starts, else in
      // device memory
      const int first = (cb + 1 - min(cb + 1, kWindow)) * kTile;
      const uint64_t* col = m + (size_t)cb * (cb + 1) / 2 * kTile;
      const uint64_t gone =
          removed_by_earlier(cb, kept, part, col, run, first, 1);
      if (tid < 32) {
        const uint64_t live = rows == kTile ? ~0ull : (1ull << rows) - 1ull;
        const uint64_t* diag = run + (r0 - first);
        const uint64_t c0 = lane < rows ? diag[lane] : 0ull;
        const uint64_t c1 = lane + 32 < rows ? diag[lane + 32] : 0ull;
        const uint64_t k = resolve(live & ~gone, c0, c1, lane);
        if (lane == 0) kept[cb] = k;
        if (g0 >= 0) keep[base + g0] = (uint8_t)((k >> lane) & 1ull);
        if (g1 >= 0) keep[base + g1] = (uint8_t)((k >> (lane + 32)) & 1ull);
        const int n0 = r0 + kTile;
        g0 = n0 + lane < s.n ? gi[n0 + lane] : -1;
        g1 = n0 + lane + 32 < s.n ? gi[n0 + lane + 32] : -1;
      }
      __syncthreads();  // kept[cb] is set, stage st free again
      if (tid == 0 && cb + kStages < words) fetch(st, cb + kStages);
    }
  }
}

// The tiled route's scratch: grouped boxes, ids and row indices, the
// segment table, the counts, the mask: an image's tiles at most
// sum over segments of w(w+1)/2, w = ceil(n_s/64) < n_s/64 + 1, so at
// most (N^2/4096 + 3N/64 + 2 min(N, 256)) / 2.
struct Layout {
  size_t gbox, gid, gidx, segs, counts, mask, total;
  int wmax;
  long long mstride;
};

Layout layout(int batch, int n, size_t tsz) {
  auto al = [](size_t x) { return (x + 255) & ~(size_t)255; };
  Layout L;
  L.wmax = (n + kTile - 1) / kTile;
  const long long nn = n;
  const long long tiles =
      (nn * nn / 4096 + 3 * nn / 64 + 2 * (nn < kBuckets ? nn : kBuckets)) / 2 + 2;
  L.mstride = tiles * kTile;
  const size_t bn = (size_t)batch * n;
  size_t off = 0;
  L.gbox = off;
  off = al(off + bn * 4 * tsz);
  L.gid = off;
  off = al(off + bn * tsz);
  L.gidx = off;
  off = al(off + bn * 4);
  L.segs = off;
  off = al(off + (size_t)batch * kBuckets * sizeof(Seg));
  L.counts = off;
  off = al(off + (size_t)batch * 2 * sizeof(int));
  L.mask = off;
  off = al(off + (size_t)batch * L.mstride * 8);
  L.total = off;
  return L;
}

int sm_count() {
  int dev = 0, nsm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return nsm;
}

template <typename T>
int launch(const void* boxes, const void* ids, const void* valid, int batch,
           int n, double thresh, void* scratch, void* keep,
           cudaStream_t stream) {
  const T th = static_cast<T>(thresh);
  const T* bx = static_cast<const T*>(boxes);
  const T* id = static_cast<const T*>(ids);
  const uint8_t* va = static_cast<const uint8_t*>(valid);
  uint8_t* kp = static_cast<uint8_t*>(keep);
  if (n <= kFusedMax) {
    static std::atomic<unsigned long long> attr{0};
    const int err = allow_smem(nms_fused<T>, kSmemMax, attr);
    if (err != 0) return err;
    nms_fused<T><<<batch * kFusedCluster, kFusedThreads,
                   fused_smem<T>(n, ids != nullptr), stream>>>(bx, id, va, n,
                                                               th, kp);
    return (int)cudaGetLastError();
  }
  if (batch > 65535 || !scratch) return (int)cudaErrorInvalidValue;
  const Layout L = layout(batch, n, sizeof(T));
  if (sweep_smem(L.wmax) > kSmemMax) return (int)cudaErrorInvalidValue;
  char* sc = static_cast<char*>(scratch);
  T* gbox = reinterpret_cast<T*>(sc + L.gbox);
  T* gid = ids ? reinterpret_cast<T*>(sc + L.gid) : nullptr;
  int* gidx = reinterpret_cast<int*>(sc + L.gidx);
  Seg* segs = reinterpret_cast<Seg*>(sc + L.segs);
  int* counts = reinterpret_cast<int*>(sc + L.counts);
  uint64_t* mask = reinterpret_cast<uint64_t*>(sc + L.mask);
  nms_group<T><<<batch, kGroupThreads, 0, stream>>>(bx, id, va, n, gbox, gid,
                                                   gidx, segs, counts, kp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nsm = sm_count();
  const int mx = max(1, min(65535, (nsm * 32 + batch - 1) / batch));
  nms_mask<T><<<dim3(mx, batch), kTile, 0, stream>>>(gbox, gid, segs, counts,
                                                     n, L.mstride, th, mask);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  static std::atomic<unsigned long long> attr{0};
  const int err = allow_smem(nms_sweep, kSmemMax, attr);
  if (err != 0) return err;
  const int sx = max(1, min(kBuckets, (nsm * 2 + batch - 1) / batch));
  nms_sweep<<<dim3(sx, batch), kSweepThreads, sweep_smem(L.wmax), stream>>>(
      segs, counts, gidx, n, L.mstride, mask, kp);
  return (int)cudaGetLastError();
}

}  // namespace

// The most rows an image the fused route (one launch) takes; above it
// the tiled route (three launches).
extern "C" int mxt_box_nms_fused_max() { return kFusedMax; }

// Bytes of scratch mxt_box_nms_keep needs for (batch, n) boxes of dtype
// (0 float32, 1 float64): none on the fused route.
extern "C" long long mxt_box_nms_scratch_bytes(int dtype, int batch, int n) {
  if (batch <= 0 || n <= kFusedMax) return 0;
  return (long long)layout(batch, n, dtype == 1 ? 8 : 4).total;
}

// boxes (B, N, 4) corner, score-sorted; ids (B, N) or null (no class
// check: every box may remove every later one); valid (B, N) uint8;
// scratch of mxt_box_nms_scratch_bytes bytes (256-byte aligned); keep
// (B, N) uint8 out.  dtype 0 float32, 1 float64.  Returns the CUDA
// error of the launches (0 on success).
extern "C" int mxt_box_nms_keep(int dtype, const void* boxes, const void* ids,
                                const void* valid, int batch, int n,
                                double thresh, void* scratch, void* keep,
                                void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(boxes, ids, valid, batch, n, thresh, scratch, keep, s);
  if (dtype == 1) return launch<double>(boxes, ids, valid, batch, n, thresh, scratch, keep, s);
  return (int)cudaErrorInvalidValue;
}
