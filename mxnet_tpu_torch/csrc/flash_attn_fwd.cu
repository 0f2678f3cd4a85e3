// Forward flash attention for Hopper (sm_90a): two hand-written kernels
// behind one C interface, chosen by the wrapper
// (mxnet_tpu_torch/parallel/attention.py, `flash_attention_fwd`).
//
// Replaces the Pallas TPU kernel `_flash_kernel` reached through
// `pallas_flash_attention` in mxnet_tpu/parallel/attention.py, and
// computes what that wrapper computes as a function, fallback cases
// included: any Tq and Tk (ragged tails are masked here, where the TPU
// wrapper fell back to its scan), and causal masking on the aligned
// diagonal q_pos = i + Tk - Tq (the TPU kernel only took Tq == Tk).
// q, k, v and o are (B, T, H, D) tensors read and written in place
// through their strides (the last dim contiguous), so the prefill's
// q/k/v views of the fused projection are read without copies.  Masked
// probabilities are exactly 0, and a row whose every key is masked
// writes 0 (acc / (l == 0 ? 1 : l)), as the scan formulation does.
// Both kernels optionally write the log-sum-exp of each row's scaled
// scores, lse = m + log(l) (natural log, f32, a (B, H, Tq) buffer), for
// the backward kernel (csrc/flash_attn_bwd.cu) to recompute P from; a
// fully masked row (l == 0) gets +inf, so exp(s - lse) is 0 there.
// Serving passes no buffer and the kernels skip the write.
// One thread block handles one (b*h, 64-row q tile); the TPU grid's
// sequential k axis becomes a loop over 64-row k/v tiles inside the
// block, with the running max m, the denominator l and the accumulator
// kept in f32 registers; tiles entirely above the causal diagonal are
// never visited, and the heaviest causal q tiles are scheduled first so
// the light ones fill the tail.
//
// Bound on an H100 at the serving prefill's largest cell (B=4, T=512,
// H=12, D=64, bf16, causal): 2*2*B*H*D*(T*(T+1)/2) = 1.6 GFLOP against
// 12.6 MB of q/k/v/o, so the card's least time is its memory, 3.8 us
// at 3.35 TB/s; the FLOPs take 1.6 us at 989 TFLOP/s on the bf16
// tensor cores.
//
// (1) `flash_fwd_wgmma`, bf16 with D = 64 or 128 (the serving path).
//     S = Q K^T and O += P V run on the tensor cores through `wgmma`
//     (m64n64k16 with both operands K-major in shared memory for S;
//     m64nDk16 with P in registers and V as the MN-major B operand for
//     O), so the arithmetic floor drops from the CUDA cores' 24 us to
//     the tensor cores' 1.6 us and the kernel can approach its bytes.
//     A producer warp feeds the consumer warpgroup with TMA: Q once, K
//     and V through a ring of STAGES 64-row tiles with full/empty
//     `mbarrier`s, so the next tile's copy overlaps this tile's math
//     and no thread spends instructions on addresses.  Tiles land in
//     shared memory with the 128-byte swizzle (a 64-wide bf16 row is
//     128 bytes; D = 128 is two 64-column boxes), which is the layout
//     `wgmma` reads without bank conflicts.  The tensor maps are 4-D
//     (D, H, T, B) over the tensors' real strides; TMA fills rows past
//     T with 0 and the kernel masks their scores to -inf (only on the
//     diagonal tile and the ragged tail).  The online softmax runs in
//     registers on the `wgmma` accumulator layout (row 16*warp + lane/4
//     and +8, columns 8*j + 2*(lane%4) and +1), with exp2 on scores
//     pre-scaled by log2(e).  O is staged in shared memory (swizzled,
//     reusing Q's tile) and written by one TMA store, which clips the
//     rows past Tq.  About 40 KB of shared memory a block at D = 64,
//     so all 384 blocks of the main cell are resident at once on 132
//     SMs.
//     Precision: P is rounded to bf16 for the P.V product, exactly as
//     the TPU kernel does (`p.astype(v_ref.dtype)`); the f32 P of
//     `_masked_attn` is no longer matched to rounding, and the added
//     error (about 2^-9 relative per weight) stays far inside the bf16
//     tolerance of 2e-2.
//     What holds it back now (about 11 us of device time at the cell
//     above on an H100 SXM at 700 W, against the 3.8 us bound): the one
//     consumer warpgroup runs S, the softmax and P.V of a tile in turn,
//     so the tensor cores idle through each softmax and only the other
//     blocks on the SM (3 fit: 104 registers, 41 KB) fill the gaps.
//     Two consumer warpgroups taking turns, or S of the next tile issued
//     before this tile's softmax, is the next step.
// (2) `flash_fwd_kernel` (SIMT), float32, and bf16 with any other head
//     dim (a multiple of 8 up to 128).  `wgmma` takes float32 only as
//     TF32, which keeps three digits and would break the float32 match
//     of `_masked_attn` that greedy decoding is held to token for token,
//     so float32 stays on CUDA-core FMAs in f32 with P kept in f32.
//     Q, K and V are widened to f32 in padded shared-memory tiles, the
//     products are scalar FMAs, so this kernel is bound by its own
//     arithmetic (24 us at the full 67 TFLOP/s of the f32 CUDA cores at
//     the cell above).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

// ---------------------------------------------------------------------------
// (2) SIMT: float32, and bf16 with other head dims
// ---------------------------------------------------------------------------
namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // k/v rows per tile
constexpr int NTHREADS = 128;
constexpr int TX = 8;           // threads sharing one row
constexpr int TY = NTHREADS / TX;
constexpr int RPT = BQ / TY;    // rows per thread
constexpr int CPT = BK / TX;    // score columns per thread
constexpr int LDP = BK + 8;     // padded row stride of the P tile
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (DMAX + 1) + 2 * BK * (DMAX + 1) +
                                  BQ * LDP);
}

// Stage rows [r0, r0 + nrows) of one (T, D) head slice into a zero-padded
// (nrows, DMAX) f32 tile with row stride DMAX + 1.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int r0,
                                          int nrows, int T_len, int D) {
  for (int idx = threadIdx.x; idx < nrows * DMAX; idx += NTHREADS) {
    const int r = idx / DMAX, d = idx % DMAX;
    const int row = r0 + r;
    dst[r * (DMAX + 1) + d] =
        (row < T_len && d < D) ? to_f32(src[(int64_t)row * row_stride + d])
                               : 0.f;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int BH, int n_qtiles, int Tq, int Tk, int D, int64_t qsb,
                 int64_t qst, int64_t qsh, int64_t ksb, int64_t kst,
                 int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh,
                 int64_t osb, int64_t ost, int64_t osh, float sm_scale,
                 int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int DPT = DMAX / TX;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int tx = threadIdx.x % TX;  // lanes 8*ty .. 8*ty+7 share rows
  const int ty = threadIdx.x / TX;
  // heaviest (last) causal q tiles first
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BQ;
  const int shift = Tk - Tq;  // aligned causal diagonal

  const T* qh = q + b * qsb + h * qsh;
  const T* kh = k + b * ksb + h * ksh;
  const T* vh = v + b * vsb + h * vsh;
  T* oh = o + b * osb + h * osh;

  load_tile<T, DMAX>(sQ, qh, qst, q0, BQ, Tq, D);

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  int k_end = Tk;
  if (causal) {
    // keys past the tile's last q position are masked for every row
    const int last_q = min(q0 + BQ, Tq) - 1 + shift;
    k_end = min(Tk, last_q + 1);
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and sQ staged)
    load_tile<T, DMAX>(sK, kh, kst, k0, BK, Tk, D);
    load_tile<T, DMAX>(sV, vh, vst, k0, BK, Tk, D);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(ty + TY * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sK[(tx + TX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int q_pos = q0 + ty + TY * i + shift;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int k_pos = k0 + tx + TX * j;
        const bool ok = k_pos < Tk && (!causal || q_pos >= k_pos);
        s[i][j] = ok ? s[i][j] * sm_scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int k_pos = k0 + tx + TX * j;
        const bool ok = k_pos < Tk && (!causal || q_pos >= k_pos);
        const float p = ok ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + TY * i) * LDP + tx + TX * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    // a row of P is written and read only by the 8 lanes that own it,
    // all in one warp
    __syncwarp();

    const int k_n = min(BK, Tk - k0);
#pragma unroll 4
    for (int c = 0; c < k_n; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty + TY * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = sV[c * LD + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= Tq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    if (lse != nullptr && tx == 0)
      lse[(int64_t)bh * Tq + row] =
          l[i] == 0.f ? __int_as_float(0x7f800000) : m[i] + logf(l[i]);
    T* orow = oh + (int64_t)row * ost;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + TX * j;
      if (d < D) store(orow + d, acc[i][j] * inv);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int Tk, int D, const long long* st,
           float sm_scale, int causal, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DMAX>;
  const size_t smem = smem_bytes<DMAX>();
  static std::atomic<unsigned long long> attr_set{0};
  const int err = allow_smem(kern, smem, attr_set);
  if (err != 0) return err;
  const int BH = B * H;
  const int n_qtiles = (Tq + BQ - 1) / BQ;
  const unsigned grid = (unsigned)n_qtiles * (unsigned)BH;
  kern<<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, H, BH, n_qtiles, Tq,
      Tk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], sm_scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// (1) bf16 on wgmma + TMA
// ---------------------------------------------------------------------------
namespace {
namespace wg {

constexpr int BQ = 64;                 // q rows per block (one wgmma M)
constexpr int BK = 64;                 // k/v rows per tile
constexpr int STAGES = 2;              // k/v ring depth
constexpr int NCONSUMER = 128;         // one warpgroup
constexpr int NTHREADS = NCONSUMER + 32;  // + one producer warp

template <int D>
constexpr size_t smem_bytes() {
  // Q, STAGES x (K, V), 1 + 2 * STAGES mbarriers, and slack to align
  // the tiles to the 1024 bytes the 128-byte swizzle repeats over
  return (size_t)(1 + 2 * STAGES) * (D / 64) * BOX_BYTES +
         8 * (1 + 2 * STAGES) + 1024;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 3 : 2)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_o,
                float* __restrict__ lse, int H, int BH, int n_qtiles, int Tq,
                int Tk, float scale_log2, int causal) {
  constexpr int NB = D / 64;  // 64-column boxes per row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sq = base;                          // [NB] boxes
  const uint32_t sk = sq + NB * BOX_BYTES;           // [STAGES][NB]
  const uint32_t sv = sk + STAGES * NB * BOX_BYTES;  // [STAGES][NB]
  const uint32_t bar_q = sv + STAGES * NB * BOX_BYTES;
  const uint32_t bar_full = bar_q + 8;               // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // [STAGES]

  // heaviest (last) causal q tiles first
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BQ;
  const int shift = Tk - Tq;  // aligned causal diagonal
  int k_end = Tk;
  // keys past the tile's last q position are masked for every row
  if (causal) k_end = min(Tk, min(q0 + BQ, Tq) + shift);
  const int n_kt = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NCONSUMER) {
    // producer warp: one lane issues every copy, then leaves (the
    // consumers wait for each copy before the block can finish)
    if (threadIdx.x == NCONSUMER) {
      mbar_expect_tx(bar_q, NB * BOX_BYTES);
      for (int c = 0; c < NB; ++c)
        tma_load(sq + c * BOX_BYTES, &map_q, bar_q, 64 * c, h, q0, b);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % STAGES;
        mbar_wait(bar_empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * NB * BOX_BYTES);
        for (int c = 0; c < NB; ++c) {
          tma_load(sk + (s * NB + c) * BOX_BYTES, &map_k, bar_full + 8 * s,
                   64 * c, h, i * BK, b);
          tma_load(sv + (s * NB + c) * BOX_BYTES, &map_v, bar_full + 8 * s,
                   64 * c, h, i * BK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
  const int cl = 2 * (lane % 4);        // and columns 8*j + cl, + 1
  const float kInf = __int_as_float(0x7f800000);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -kInf, m1 = -kInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);

  for (int i = 0; i < n_kt; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BK;
    mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);

    // S = Q K^T: D/16 steps of k16 along the 128-byte swizzled rows
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss_m64n64(sc, desc(sq + off, 16, 1024),
                      desc(sk + s * NB * BOX_BYTES + off, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] *= scale_log2;
    // mask only where some key is past Tk or above the diagonal
    if (k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + shift)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = k0 + 8 * (e / 4) + cl + (e & 1);
        const int qpos = q0 + r0 + ((e & 2) ? 8 : 0) + shift;
        if (col >= Tk || (causal && col > qpos)) sc[e] = -kInf;
      }
    }

    // online softmax on rows r0 (even pairs) and r0 + 8 (odd pairs);
    // the four lanes of a row reduce with two shuffles
    float mx0 = -kInf, mx1 = -kInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with every key masked so far keeps base 0: exp2(-inf) = 0
    const float b0 = mn0 == -kInf ? 0.f : mn0;
    const float b1 = mn1 == -kInf ? 0.f : mn1;
    const float corr0 = exp2f(m0 - b0), corr1 = exp2f(m1 - b1);
    m0 = mn0;
    m1 = mn1;

    // P as the bf16 A operand of P V: k-step kk takes score columns
    // 16*kk .. 16*kk+15, i.e. accumulator entries 8*kk .. 8*kk+7
    uint32_t pa[16];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        p[e] = exp2f(sc[8 * kk + e] - ((e & 2) ? b1 : b0));
      rs0 += p[0] + p[1] + p[4] + p[5];
      rs1 += p[2] + p[3] + p[6] + p[7];
      pa[4 * kk + 0] = pack_bf16(p[0], p[1]);
      pa[4 * kk + 1] = pack_bf16(p[2], p[3]);
      pa[4 * kk + 2] = pack_bf16(p[4], p[5]);
      pa[4 * kk + 3] = pack_bf16(p[6], p[7]);
    }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }

    // O += P V: V (BK x D, D contiguous) is the MN-major B operand;
    // k-step kk reads rows 16*kk .. 16*kk+15 (two 8-row groups 1024
    // bytes apart), the 64-column boxes lie BOX_BYTES apart
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(o, pa + 4 * kk,
                  desc(sv + s * NB * BOX_BYTES + kk * 2048, BOX_BYTES, 1024));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    mbar_arrive(bar_empty + 8 * s);  // this thread is done with stage s
  }

  // epilogue: o / l in f32, rounded to bf16, staged in Q's tile with
  // the store map's 128-byte swizzle (16-byte chunk c of row r sits at
  // chunk c ^ (r % 8)), then one TMA store that clips rows past Tq
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  if (lse != nullptr && (lane & 3) == 0) {
    // m is in log2 units of the scaled scores
    float* lrow = lse + (int64_t)bh * Tq + q0;
    if (q0 + r0 < Tq)
      lrow[r0] = l0 == 0.f ? kInf : (m0 + log2f(l0)) * kLn2;
    if (q0 + r0 + 8 < Tq)
      lrow[r0 + 8] = l1 == 0.f ? kInf : (m1 + log2f(l1)) * kLn2;
  }
  // every warp's last wgmma has read Q before any warp overwrites it
  asm volatile("bar.sync 1, %0;" ::"n"(NCONSUMER) : "memory");
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const uint32_t box = (j / 8) * BOX_BYTES, chunk = j % 8;
    const uint32_t lo = box + r0 * 128 + ((chunk ^ (r0 & 7)) << 4) +
                        4 * (lane % 4);
    const uint32_t hi = box + (r0 + 8) * 128 +
                        ((chunk ^ ((r0 + 8) & 7)) << 4) + 4 * (lane % 4);
    *reinterpret_cast<uint32_t*>(gbase + lo) =
        pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(gbase + hi) =
        pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  // make the generic-proxy writes visible to the TMA (async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, %0;" ::"n"(NCONSUMER) : "memory");
  if (tid == 0) {
    for (int c = 0; c < NB; ++c)
      tma_store(&map_o, sq + c * BOX_BYTES, 64 * c, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // the shared memory must outlive the store's reads
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int Tk, const long long* maps, float sm_scale,
           int causal, cudaStream_t stream) {
  auto kern = flash_fwd_wgmma<D>;
  static std::atomic<unsigned long long> attr_set{0};
  int err = allow_smem(kern, smem_bytes<D>(), attr_set);
  if (err != 0) return err;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv, mo;
  if ((err = make_map(&mq, encode, q, maps)) ||
      (err = make_map(&mk, encode, k, maps + 11)) ||
      (err = make_map(&mv, encode, v, maps + 22)) ||
      (err = make_map(&mo, encode, o, maps + 33)))
    return err;
  const int BH = B * H;
  const int n_qtiles = (Tq + BQ - 1) / BQ;
  const unsigned grid = (unsigned)n_qtiles * (unsigned)BH;
  kern<<<grid, NTHREADS, smem_bytes<D>(), stream>>>(
      mq, mk, mv, mo, lse, H, BH, n_qtiles, Tq, Tk,
      sm_scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace

// The C interface: each entry takes every integer argument in one
// packed int64 array (cheaper for the Python caller to build than
// separate ctypes arguments) and returns a cudaError_t, 0 on a
// successful launch.  Both start with the same 12 numbers:
//   q, k, v, o (device pointers), B, H, Tq, Tk, D, causal, stream,
//   device (the launch switches to it and back when it is not current)
enum { A_Q, A_K, A_V, A_O, A_B, A_H, A_TQ, A_TK, A_D, A_CAUSAL, A_STREAM,
       A_DEVICE, A_HEAD };

// Both entries take `lse`, a (B, H, Tq) float32 buffer for the rows'
// log-sum-exp, or NULL to skip it.
//
// SIMT kernel.  After the head: dtype (0 = float32, 1 = bfloat16), then
// 12 element strides, the (batch, seq, head) strides of q, k, v and o.
extern "C" int mxt_flash_attn_fwd(const long long* a, float sm_scale,
                                  float* lse) {
  const int B = (int)a[A_B], H = (int)a[A_H], Tq = (int)a[A_TQ],
            Tk = (int)a[A_TK], D = (int)a[A_D], causal = (int)a[A_CAUSAL];
  const void *q = (const void*)a[A_Q], *k = (const void*)a[A_K],
             *v = (const void*)a[A_V];
  void* o = (void*)a[A_O];
  const long long dtype = a[A_HEAD], *strides = a + A_HEAD + 1;
  if (D <= 0 || D > 128 || D % 8 != 0 || B <= 0 || H <= 0 || Tq <= 0 ||
      Tk <= 0)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard((int)a[A_DEVICE]);
  if (guard.err) return guard.err;
  cudaStream_t s = (cudaStream_t)a[A_STREAM];
  if (dtype == 0) {
    return D <= 64 ? launch<float, 64>(q, k, v, o, lse, B, H, Tq, Tk, D,
                                       strides, sm_scale, causal, s)
                   : launch<float, 128>(q, k, v, o, lse, B, H, Tq, Tk, D,
                                        strides, sm_scale, causal, s);
  }
  if (dtype == 1) {
    return D <= 64
               ? launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, Tq, Tk, D,
                                           strides, sm_scale, causal, s)
               : launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, Tq, Tk, D,
                                            strides, sm_scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

// wgmma kernel, bfloat16 with D = 64 or 128.  After the head: 4 x 11
// numbers, the TMA map arguments of q, k, v and o (see make_map).
extern "C" int mxt_flash_attn_fwd_wgmma(const long long* a, float sm_scale,
                                        float* lse) {
  const int B = (int)a[A_B], H = (int)a[A_H], Tq = (int)a[A_TQ],
            Tk = (int)a[A_TK], D = (int)a[A_D], causal = (int)a[A_CAUSAL];
  if ((D != 64 && D != 128) || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard((int)a[A_DEVICE]);
  if (guard.err) return guard.err;
  const void *q = (const void*)a[A_Q], *k = (const void*)a[A_K],
             *v = (const void*)a[A_V];
  void* o = (void*)a[A_O];
  cudaStream_t s = (cudaStream_t)a[A_STREAM];
  const long long* maps = a + A_HEAD;
  return D == 64 ? wg::launch<64>(q, k, v, o, lse, B, H, Tq, Tk, maps,
                                  sm_scale, causal, s)
                 : wg::launch<128>(q, k, v, o, lse, B, H, Tq, Tk, maps,
                                   sm_scale, causal, s);
}
