// Greedy non-maximum suppression over score-sorted boxes, for sm_90a.
//
// Replaces no TPU kernel: the JAX package's box_nms
// (mxnet_tpu/ops/contrib.py:41, also under MultiBoxDetection :278 and
// the RPN's _proposal_single :339) is a lax.fori_loop of N steps over an
// N x N IoU matrix per image, which XLA keeps on the chip.  On the card
// that loop would be N host iterations of several launches each, so the
// port does what the reference's bounding_box.cu does:
//
//   1. nms_mask: one thread per (image, row i, 64-column block) computes
//      the 64 suppression bits "iou(i, j) > thresh, same class, j > i"
//      into a word of a (B, N, ceil(N/64)) bit matrix.  Column boxes are
//      staged in shared memory, one tile of 64 a block.
//   2. nms_sweep: one warp per image walks the rows in score order and
//      ORs row i's words into a "removed" bit set in shared memory when
//      box i is valid and not removed yet: the greedy loop, exact, with
//      N steps inside one block instead of N launches.
//
// Bounds on an H100: the mask is the arithmetic (about 12 operations an
// IoU pair, N^2/2 pairs an image, against 67 TFLOP/s of float32) and
// writes B*N*N/8 bytes; the sweep is a chain of N dependent shared
// memory steps an image, latency-bound (the images run in parallel, one
// warp each).  The IoU is computed with the round-to-nearest intrinsics
// (no fused multiply-add) so that every bit matches the plain version's
// element-wise PyTorch ops, and the keep masks agree exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;

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

// ops/contrib.py _box_iou_corner, operation for operation
template <typename T>
__device__ __forceinline__ T iou_corner(const T* a, const T* b) {
  const T zero = T(0);
  T tl0 = vmax(a[0], b[0]), tl1 = vmax(a[1], b[1]);
  T br0 = vmin(a[2], b[2]), br1 = vmin(a[3], b[3]);
  T w = vmax(rn_sub(br0, tl0), zero), h = vmax(rn_sub(br1, tl1), zero);
  T inter = rn_mul(w, h);
  T area_a = rn_mul(vmax(rn_sub(a[2], a[0]), zero), vmax(rn_sub(a[3], a[1]), zero));
  T area_b = rn_mul(vmax(rn_sub(b[2], b[0]), zero), vmax(rn_sub(b[3], b[1]), zero));
  T uni = vmax(rn_sub(rn_add(area_a, area_b), inter), T(1e-12));
  return rn_div(inter, uni);
}

// grid (col_blocks, row_blocks, B), kTile threads: thread t owns row
// row_block*64 + t and writes its word for col_block
template <typename T>
__global__ void nms_mask(const T* __restrict__ boxes, const T* __restrict__ ids,
                         int n, int col_blocks, T thresh,
                         unsigned long long* __restrict__ mask) {
  const int b = blockIdx.z;
  const int col0 = blockIdx.x * kTile, row = blockIdx.y * kTile + threadIdx.x;
  __shared__ T cols[kTile * 4];
  __shared__ T col_ids[kTile];
  const T* bb = boxes + (size_t)b * n * 4;
  int c = col0 + threadIdx.x;
  if (c < n) {
#pragma unroll
    for (int k = 0; k < 4; ++k) cols[threadIdx.x * 4 + k] = bb[(size_t)c * 4 + k];
    if (ids) col_ids[threadIdx.x] = ids[(size_t)b * n + c];
  }
  __syncthreads();
  if (row >= n) return;
  unsigned long long bits = 0;
  // columns at or before the row never get a bit: skip whole tiles of them
  if (col0 + kTile - 1 > row) {
    T me[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) me[k] = bb[(size_t)row * 4 + k];
    const T my_id = ids ? ids[(size_t)b * n + row] : T(0);
    const int cn = min(kTile, n - col0);
    for (int j = 0; j < cn; ++j) {
      const int col = col0 + j;
      if (col <= row) continue;
      if (ids && col_ids[j] != my_id) continue;
      if (iou_corner(me, cols + j * 4) > thresh) bits |= 1ull << j;
    }
  }
  mask[((size_t)b * n + row) * col_blocks + blockIdx.x] = bits;
}

// grid (B), one warp: the greedy sweep over the rows in score order
__global__ void nms_sweep(const unsigned long long* __restrict__ mask,
                          const uint8_t* __restrict__ valid, int n,
                          int col_blocks, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x, lane = threadIdx.x;
  const unsigned long long* m = mask + (size_t)b * n * col_blocks;
  const uint8_t* v = valid + (size_t)b * n;
  for (int w = lane; w < col_blocks; w += 32) removed[w] = 0ull;
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    // row i's words carry bits of columns after i only, so no lane's OR
    // in this step changes the bit read here
    const bool alive = v[i] && !((removed[i >> 6] >> (i & 63)) & 1ull);
    if (alive) {
      const unsigned long long* row = m + (size_t)i * col_blocks;
      for (int w = (i >> 6) + lane; w < col_blocks; w += 32) removed[w] |= row[w];
    }
    __syncwarp();
  }
  uint8_t* kb = keep + (size_t)b * n;
  for (int i = lane; i < n; i += 32)
    kb[i] = v[i] && !((removed[i >> 6] >> (i & 63)) & 1ull);
}

template <typename T>
int launch(const void* boxes, const void* ids, const void* valid, int batch, int n,
           double thresh, void* mask, void* keep, cudaStream_t stream) {
  const int col_blocks = (n + kTile - 1) / kTile;
  const size_t smem = (size_t)col_blocks * sizeof(unsigned long long);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid(col_blocks, col_blocks, batch);
  nms_mask<T><<<grid, kTile, 0, stream>>>(
      static_cast<const T*>(boxes), static_cast<const T*>(ids), n, col_blocks,
      static_cast<T>(thresh), static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_sweep<<<batch, 32, smem, stream>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), n, col_blocks,
      static_cast<uint8_t*>(keep));
  return (int)cudaGetLastError();
}

}  // namespace

// boxes (B, N, 4) corner, score-sorted; ids (B, N) or null (no class
// check); valid (B, N) uint8; mask scratch (B, N, ceil(N/64)) 64-bit
// words; keep (B, N) uint8 out.  dtype 0 float32, 1 float64.  Returns
// the CUDA error of the launches (0 on success).
extern "C" int mxt_box_nms_keep(int dtype, const void* boxes, const void* ids,
                                const void* valid, int batch, int n,
                                double thresh, void* mask, void* keep,
                                void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(boxes, ids, valid, batch, n, thresh, mask, keep, s);
  if (dtype == 1) return launch<double>(boxes, ids, valid, batch, n, thresh, mask, keep, s);
  return (int)cudaErrorInvalidValue;
}
