// Backward flash attention for Hopper (sm_90a): the gradient of the
// forward kernels in csrc/flash_attn_fwd.cu, behind two C entry points
// chosen by the wrapper (mxnet_tpu_torch/parallel/attention.py,
// `flash_attention_bwd` and `bwd_route`, through the autograd Function
// `FlashAttention`).
//
// Replaces the VJP that XLA derives for the JAX package's training
// attention, the `lax.scan` `flash_attention` of
// mxnet_tpu/parallel/attention.py (the TPU kernel `_flash_kernel` /
// `pallas_flash_attention` there is forward only, so the JAX package
// trains through the scan).  Same function: any Tq and Tk, causal on the
// aligned diagonal q_pos = i + Tk - Tq, ragged tails masked, and a row
// whose every key is masked (causal with Tq > Tk) gets dq = 0 and adds
// nothing to dk or dv.
//
// Method (FlashAttention-2, recompute): with lse the forward's per-row
// log-sum-exp of the scaled scores (+inf for a fully masked row),
//   D_i = rowsum(dO * O)                 (f32)
//   P   = exp(S * scale - lse)           (0 where masked)
//   dV  = P^T dO,   dP = dO V^T,   dS = P * (dP - D)
//   dQ  = dS K * scale,   dK = dS^T Q * scale
// accumulated in f32, from q/k/v/o/dO read through their (batch, seq,
// head) strides (the last dim contiguous; the training path hands in
// the strided q/k/v views of the fused projection).  Each route is two
// launches, in stream order:
//   (a) the dq kernel, one block a (b*h, 64-row q tile), heaviest causal
//       tiles first: D for its rows (written to a scratch (B, H, Tq)
//       buffer), then a loop over the k/v tiles up to the causal limit
//       accumulating dQ;
//   (b) the dk/dv kernel, one block a (b*h, 64-row k tile): a loop over
//       the q tiles from the causal limit on, accumulating dK and dV.
// No atomics: every output element is summed by one thread in a fixed
// order, so the gradient is bitwise the same run to run (a resumed run
// on the card equals the uninterrupted one).  The price is S and dP
// computed twice, 7 tile products where an atomic dQ would take 5.
//
// Bound on an H100 at the training cell (B=8, T=1024, H=12, D=64,
// bf16, causal): 5 products of 2*B*H*D*(T*(T+1)/2) = 32.3 GFLOP, 33 us
// at 989 TFLOP/s on the bf16 tensor cores (the bytes, 101 MB of q, k, v,
// o, dO, lse read and dq, dk, dv written, take 30 us).
//
// (1) `wgmma` (`flash_bwd_dq_wgmma` / `flash_bwd_dkv_wgmma`): bf16 with
//     D = 64 or 128 and 16-byte aligned bases and strides, the training
//     path.  Each kernel has the forward's shape (csrc/flash_attn_fwd.cu,
//     helpers in csrc/hopper.cuh): a producer warp feeds one consumer
//     warpgroup of 128 threads through TMA, the block's own 64-row tiles
//     once (Q, dO and O in (a); K and V in (b)) and the streamed 64-row
//     tiles (K, V in (a); Q, dO in (b)) through a ring of STAGES stages
//     with full/empty `mbarrier`s, so the next tile's copy overlaps this
//     tile's math.  Tiles land with the 128-byte swizzle through 4-D
//     tensor maps (D, H, T, B) over the real strides; TMA fills rows past
//     T with 0.  The products run on `wgmma` in only the two forms the
//     forward uses: S = Q K^T and dP = dO V^T (in (b) S^T = K Q^T and
//     dP^T = V dO^T) shared x shared with both operands K-major
//     (m64n64k16); dQ += dS K (in (b) dV += P^T dO and dK += dS^T Q) with
//     the bf16 A operand in registers, packed from the f32 accumulator
//     layout, and the streamed tile as the MN-major B operand
//     (m64nDk16).  P and dS are rounded to bf16 for those products, as
//     FlashAttention-2 does.  The masks (causal, and keys past Tk) run
//     only on the diagonal tile and the ragged tail; rows past Tq get lse
//     = +inf, so their P is exactly 0.  (a) computes D from the O and dO
//     tiles in shared memory; the (B, H, Tq) float32 rows of lse and D
//     are not 16-byte aligned for every Tq, so in (b) the producer warp
//     copies each streamed tile's 64 values with ordinary loads into the
//     stage (its 32 lanes arrive on the stage's full barrier after
//     writing).  (b) keeps dK and dV in registers across its loop (64 or
//     128 f32 a thread), so it runs each q tile in two passes of 32 q rows
//     (m64n32k16 for S^T and dP^T): 125 registers, three blocks an SM at
//     D = 64 (154 and two blocks with one 64-row pass, 2-3 % slower on
//     the card).  Outputs are staged in shared memory (in Q/K/V's tiles)
//     and written by TMA stores that clip rows past T.
//     What holds it back (0.128-0.133 ms of device time at the training
//     cell on an H100 SXM at 700 W, dK/dV 0.070 and dQ 0.056, against the
//     33 us bound): each block's one warpgroup runs its products and the
//     exponentials between them in turn, and only the other two blocks on
//     the SM fill the tensor cores' gaps; without any exponential dQ
//     still takes 46 us, against 21 us of tensor time.  Not the copies: a
//     3-stage ring, and even skipping the streamed copies, left both
//     kernels' times unchanged.  Not the order within a tile: P (and dS)
//     computed while dP (and dV) run left dQ unchanged.  Not occupancy
//     alone: dQ in 32-key passes at 90 registers (four blocks an SM), or
//     with Q and dO as register A operands (fewer shared-memory reads,
//     two blocks), ran 18 % slower.  The next step is software pipelining
//     across tiles (the next tile's S and dP issued before this tile's
//     softmax, with registers for two sets of them) or two consumer
//     warpgroups taking turns.
// (2) SIMT (`flash_bwd_dq` / `flash_bwd_dkv`): float32, and bf16 with any
//     other head dim or alignment.  Scalar f32 FMAs from f32 shared-memory
//     tiles, P and dS kept in f32: bound by the CUDA cores (67 TFLOP/s)
//     and their shared-memory loads, about one a two FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "hopper.cuh"


// ---------------------------------------------------------------------------
// (2) SIMT: float32, and bf16 with other head dims or alignment
// ---------------------------------------------------------------------------
namespace {

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 64;          // k/v rows per tile
constexpr int NTHREADS = 256;
constexpr int TX = 16;          // threads along a tile's columns
constexpr int TY = NTHREADS / TX;
constexpr int RPT = BQ / TY;    // tile rows per thread (4)
constexpr int CPT = BK / TX;    // tile columns per thread (4)
constexpr int LDS = BK + 1;     // padded row stride of the P and dS tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// (batch, seq, head) element strides of q, k, v, o, dO, dq, dk, dv
enum { S_Q = 0, S_K = 3, S_V = 6, S_O = 9, S_DO = 12, S_DQ = 15, S_DK = 18,
       S_DV = 21, N_STRIDES = 24 };
struct Strides {
  long long s[N_STRIDES];
};

template <int DMAX>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles (the K tile holds O while D is computed), dS, D
  return sizeof(float) * (size_t)(4 * 64 * (DMAX + 1) + BQ * LDS + BQ);
}

template <int DMAX>
constexpr size_t dkv_smem_bytes() {
  // Q, dO, K, V tiles, P, dS
  return sizeof(float) * (size_t)(4 * 64 * (DMAX + 1) + 2 * BQ * LDS);
}

// Stage rows [r0, r0 + 64) of one (T, D) head slice into a zero-padded
// (64, DMAX) f32 tile with row stride DMAX + 1.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int r0,
                                          int T_len, int D) {
  for (int idx = threadIdx.x; idx < 64 * DMAX; idx += NTHREADS) {
    const int r = idx / DMAX, d = idx % DMAX;
    const int row = r0 + r;
    dst[r * (DMAX + 1) + d] =
        (row < T_len && d < D) ? to_f32(src[(int64_t)row * row_stride + d])
                               : 0.f;
  }
}

// s = A B^T and dp = A2 B2^T on this thread's (RPT x CPT) entries of a
// 64 x 64 tile: rows ty + TY*i of the A tiles, rows tx + TX*j of the B
// tiles, over d < D.
template <int DMAX>
__device__ __forceinline__ void tile_products(const float* sA,
                                              const float* sB,
                                              const float* sA2,
                                              const float* sB2, int D,
                                              float (&s)[RPT][CPT],
                                              float (&dp)[RPT][CPT]) {
  constexpr int LD = DMAX + 1;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RPT], a2[RPT], b[CPT], b2[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      a[i] = sA[(ty + TY * i) * LD + d];
      a2[i] = sA2[(ty + TY * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      b[j] = sB[(tx + TX * j) * LD + d];
      b2[j] = sB2[(tx + TX * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(a2[i], b2[j], dp[i][j]);
      }
  }
}

// P and dS of this thread's entries, in place of s and dp: q tile rows
// q0 + ty + TY*i (lse and D of those rows given), k tile columns
// k0 + tx + TX*j.
__device__ __forceinline__ void probs_and_dscores(
    float (&s)[RPT][CPT], float (&dp)[RPT][CPT], const float (&lse)[RPT],
    const float (&dsum)[RPT], int q0, int k0, int Tq, int Tk, int shift,
    int causal, float sm_scale) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + TY * i;
    const int q_pos = row + shift;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int k_pos = k0 + tx + TX * j;
      const bool ok = row < Tq && k_pos < Tk && (!causal || q_pos >= k_pos);
      const float p = ok ? expf(s[i][j] * sm_scale - lse[i]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dsum[i]);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ dsum_out, T* __restrict__ dq, int H, int BH,
             int n_qtiles, int Tq, int Tk, int D, const Strides st,
             float sm_scale, int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int DPT = DMAX / TX;  // dq columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + 64 * LD;
  float* sK = sdO + 64 * LD;
  float* sV = sK + 64 * LD;
  float* sdS = sV + 64 * LD;
  float* sD = sdS + BQ * LDS;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  // heaviest (last) causal q tiles first
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BQ;
  const int shift = Tk - Tq;  // aligned causal diagonal

  const T* qh = q + b * st.s[S_Q] + h * st.s[S_Q + 2];
  const T* kh = k + b * st.s[S_K] + h * st.s[S_K + 2];
  const T* vh = v + b * st.s[S_V] + h * st.s[S_V + 2];
  const T* oh = o + b * st.s[S_O] + h * st.s[S_O + 2];
  const T* doh = dout + b * st.s[S_DO] + h * st.s[S_DO + 2];
  T* dqh = dq + b * st.s[S_DQ] + h * st.s[S_DQ + 2];
  const int64_t row0 = (int64_t)bh * Tq;  // this head's rows of lse and D

  load_tile<T, DMAX>(sQ, qh, st.s[S_Q + 1], q0, Tq, D);
  load_tile<T, DMAX>(sdO, doh, st.s[S_DO + 1], q0, Tq, D);
  load_tile<T, DMAX>(sK, oh, st.s[S_O + 1], q0, Tq, D);  // O, for D
  __syncthreads();
  {
    // D = rowsum(dO * O): four lanes a row, then two shuffles
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    float acc = 0.f;
    for (int d = part; d < D; d += 4)
      acc = fmaf(sdO[r * LD + d], sK[r * LD + d], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      sD[r] = acc;
      if (q0 + r < Tq) dsum_out[row0 + q0 + r] = acc;
    }
  }
  __syncthreads();
  float lse_r[RPT], dsum[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + TY * i;
    lse_r[i] = row < Tq ? lse[row0 + row] : 0.f;
    dsum[i] = sD[ty + TY * i];
  }

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  int k_end = Tk;
  // keys past the tile's last q position are masked for every row
  if (causal) k_end = min(Tk, min(q0 + BQ, Tq) + shift);

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K and dS fully read
    load_tile<T, DMAX>(sK, kh, st.s[S_K + 1], k0, Tk, D);
    load_tile<T, DMAX>(sV, vh, st.s[S_V + 1], k0, Tk, D);
    __syncthreads();
    float s[RPT][CPT], ds[RPT][CPT];
    tile_products<DMAX>(sQ, sK, sdO, sV, D, s, ds);
    probs_and_dscores(s, ds, lse_r, dsum, q0, k0, Tq, Tk, shift, causal,
                      sm_scale);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        sdS[(ty + TY * i) * LDS + tx + TX * j] = ds[i][j];
    __syncthreads();
    const int k_n = min(BK, Tk - k0);
#pragma unroll 4
    for (int c = 0; c < k_n; ++c) {
      float dsv[RPT], kv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = sdS[(ty + TY * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = sK[c * LD + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= Tq) continue;
    T* out = dqh + (int64_t)row * st.s[S_DQ + 1];
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + TX * j;
      if (d < D) store(out + d, acc[i][j] * sm_scale);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ dsum_in, T* __restrict__ dk,
              T* __restrict__ dv, int H, int BH, int Tq, int Tk, int D,
              const Strides st, float sm_scale, int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int DPT = DMAX / TX;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + 64 * LD;
  float* sK = sdO + 64 * LD;
  float* sV = sK + 64 * LD;
  float* sP = sV + 64 * LD;
  float* sdS = sP + BQ * LDS;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  // the first k tiles see the most causal q rows: they go first
  const int kt = (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int k0 = kt * BK;
  const int shift = Tk - Tq;

  const T* qh = q + b * st.s[S_Q] + h * st.s[S_Q + 2];
  const T* kh = k + b * st.s[S_K] + h * st.s[S_K + 2];
  const T* vh = v + b * st.s[S_V] + h * st.s[S_V + 2];
  const T* doh = dout + b * st.s[S_DO] + h * st.s[S_DO + 2];
  T* dkh = dk + b * st.s[S_DK] + h * st.s[S_DK + 2];
  T* dvh = dv + b * st.s[S_DV] + h * st.s[S_DV + 2];
  const int64_t row0 = (int64_t)bh * Tq;

  load_tile<T, DMAX>(sK, kh, st.s[S_K + 1], k0, Tk, D);
  load_tile<T, DMAX>(sV, vh, st.s[S_V + 1], k0, Tk, D);

  // this thread's dK and dV entries: tile rows ty + TY*i, columns
  // tx + TX*j
  float acc_k[RPT][DPT], acc_v[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  int qt_begin = 0;
  if (causal) {
    // q rows before position k0 see none of these keys
    const int first = k0 - shift;
    qt_begin = first > 0 ? first / BQ : 0;
  }
  const int n_qtiles = (Tq + BQ - 1) / BQ;
  for (int qt = qt_begin; qt < n_qtiles; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous q tile, P and dS fully read
    load_tile<T, DMAX>(sQ, qh, st.s[S_Q + 1], q0, Tq, D);
    load_tile<T, DMAX>(sdO, doh, st.s[S_DO + 1], q0, Tq, D);
    float lse_r[RPT], dsum[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + TY * i;
      lse_r[i] = row < Tq ? lse[row0 + row] : 0.f;
      dsum[i] = row < Tq ? dsum_in[row0 + row] : 0.f;
    }
    __syncthreads();
    float s[RPT][CPT], ds[RPT][CPT];
    tile_products<DMAX>(sQ, sK, sdO, sV, D, s, ds);
    probs_and_dscores(s, ds, lse_r, dsum, q0, k0, Tq, Tk, shift, causal,
                      sm_scale);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        sP[(ty + TY * i) * LDS + tx + TX * j] = s[i][j];
        sdS[(ty + TY * i) * LDS + tx + TX * j] = ds[i][j];
      }
    __syncthreads();
    const int q_n = min(BQ, Tq - q0);
#pragma unroll 2
    for (int r = 0; r < q_n; ++r) {
      float pv[RPT], dsv[RPT], ov[DPT], qv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = sP[r * LDS + ty + TY * i];
        dsv[i] = sdS[r * LDS + ty + TY * i];
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        ov[j] = sdO[r * LD + tx + TX * j];
        qv[j] = sQ[r * LD + tx + TX * j];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qv[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + ty + TY * i;
    if (row >= Tk) continue;
    T* krow = dkh + (int64_t)row * st.s[S_DK + 1];
    T* vrow = dvh + (int64_t)row * st.s[S_DV + 1];
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + TX * j;
      if (d < D) {
        store(krow + d, acc_k[i][j] * sm_scale);
        store(vrow + d, acc_v[i][j]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* dsum;
  void *dq, *dk, *dv;
  int B, H, Tq, Tk, D, causal;
};

template <typename T, int DMAX>
int launch(const Args& a, const Strides& st, float sm_scale,
           cudaStream_t stream) {
  auto kq = flash_bwd_dq<T, DMAX>;
  auto kkv = flash_bwd_dkv<T, DMAX>;
  static std::atomic<unsigned long long> attr_q{0}, attr_kv{0};
  int err = allow_smem(kq, dq_smem_bytes<DMAX>(), attr_q);
  if (err != 0) return err;
  err = allow_smem(kkv, dkv_smem_bytes<DMAX>(), attr_kv);
  if (err != 0) return err;
  const int BH = a.B * a.H;
  const int n_qtiles = (a.Tq + BQ - 1) / BQ;
  const int n_ktiles = (a.Tk + BK - 1) / BK;
  kq<<<(unsigned)n_qtiles * (unsigned)BH, NTHREADS, dq_smem_bytes<DMAX>(),
       stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.o,
                 (const T*)a.dout, a.lse, a.dsum, (T*)a.dq, a.H, BH, n_qtiles,
                 a.Tq, a.Tk, a.D, st, sm_scale, a.causal);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  // reads the D rows the first launch wrote (same stream)
  kkv<<<(unsigned)n_ktiles * (unsigned)BH, NTHREADS, dkv_smem_bytes<DMAX>(),
        stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v,
                  (const T*)a.dout, a.lse, a.dsum, (T*)a.dk, (T*)a.dv, a.H, BH,
                  a.Tq, a.Tk, a.D, st, sm_scale, a.causal);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// (1) wgmma: bf16, D = 64 or 128, on the tensor cores fed by TMA
// ---------------------------------------------------------------------------
namespace {
namespace wg {

constexpr int BQ = 64;                    // q rows of a tile
constexpr int BK = 64;                    // k/v rows of a tile
constexpr int STAGES = 2;                 // ring depth
constexpr int NCONSUMER = 128;            // one warpgroup
constexpr int NTHREADS = NCONSUMER + 32;  // + one producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, O, STAGES x (K, V), 1 + 2 * STAGES mbarriers, and slack to
  // align the tiles to the 1024 bytes the 128-byte swizzle repeats over
  return (size_t)(3 + 2 * STAGES) * (D / 64) * BOX_BYTES +
         8 * (1 + 2 * STAGES) + 1024;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, STAGES x (Q, dO), STAGES x (64 lse, 64 D) floats, mbarriers,
  // slack
  return (size_t)(2 + 2 * STAGES) * (D / 64) * BOX_BYTES +
         STAGES * 2 * 64 * sizeof(float) + 8 * (1 + 2 * STAGES) + 1024;
}

// 2^x on the special-function unit, subnormal results flushed to 0
// (exp2f adds a compare and two multiplies to keep them: a third of the
// instructions between the products)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NCONSUMER) : "memory");
}

// This lane's share of rowsum(a * b) over row r of two (64, D) bf16 tiles
// in the 128-byte swizzle (16-byte chunk c of row r sits at chunk
// c ^ (r % 8)): chunks `part` and `part` + 4 of every 64-column box, the
// four lanes of a row taking parts 0..3.
template <int D>
__device__ __forceinline__ float row_dot(const uint8_t* a, const uint8_t* b,
                                         int r, int part) {
  float acc = 0.f;
#pragma unroll
  for (int box = 0; box < D / 64; ++box)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = part + 4 * half;
      const uint32_t off = box * BOX_BYTES + r * 128 + ((c ^ (r & 7)) << 4);
      const uint4 x = *reinterpret_cast<const uint4*>(a + off);
      const uint4 y = *reinterpret_cast<const uint4*>(b + off);
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yv = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fx = __bfloat1622float2(xv[i]);
        const float2 fy = __bfloat1622float2(yv[i]);
        acc = fmaf(fx.x, fy.x, acc);
        acc = fmaf(fx.y, fy.y, acc);
      }
    }
  return acc;
}

// A 64 x D f32 accumulator (the wgmma layout: rows r0 and r0 + 8, columns
// 8 * j + 2 * (lane % 4) and + 1) times `scale`, rounded to bf16 into the
// (64, D) tile at `tile` in the store map's 128-byte swizzle.
template <int D>
__device__ __forceinline__ void stage_tile(uint8_t* tile,
                                           const float (&acc)[D / 2],
                                           float scale, int r0, int lane) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const uint32_t box = (j / 8) * BOX_BYTES, chunk = j % 8;
    const uint32_t lo = box + r0 * 128 + ((chunk ^ (r0 & 7)) << 4) +
                        4 * (lane % 4);
    const uint32_t hi = box + (r0 + 8) * 128 +
                        ((chunk ^ ((r0 + 8) & 7)) << 4) + 4 * (lane % 4);
    *reinterpret_cast<uint32_t*>(tile + lo) =
        pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(tile + hi) =
        pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// (a) dQ and D for one (b*h, 64-row q tile).
template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_o,
                   const __grid_constant__ CUtensorMap map_do,
                   const __grid_constant__ CUtensorMap map_dq,
                   const float* __restrict__ lse, float* __restrict__ dsum_out,
                   int H, int BH, int n_qtiles, int Tq, int Tk,
                   float scale_log2, float sm_scale, int causal) {
  constexpr int NB = D / 64;                 // 64-column boxes per row
  constexpr uint32_t TILE = NB * BOX_BYTES;  // one (64, D) tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sq = base, sdo = sq + TILE, so = sdo + TILE;
  const uint32_t sk = so + TILE;                // [STAGES]
  const uint32_t sv = sk + STAGES * TILE;       // [STAGES]
  const uint32_t bar_fix = sv + STAGES * TILE;  // Q, dO and O
  const uint32_t bar_full = bar_fix + 8;        // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * STAGES;

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
    mbar_init(bar_fix, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NCONSUMER) {
    // producer warp: one lane issues every copy, then leaves
    if (threadIdx.x == NCONSUMER) {
      mbar_expect_tx(bar_fix, 3 * TILE);
      for (int c = 0; c < NB; ++c) {
        tma_load(sq + c * BOX_BYTES, &map_q, bar_fix, 64 * c, h, q0, b);
        tma_load(sdo + c * BOX_BYTES, &map_do, bar_fix, 64 * c, h, q0, b);
        tma_load(so + c * BOX_BYTES, &map_o, bar_fix, 64 * c, h, q0, b);
      }
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % STAGES;
        mbar_wait(bar_empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * TILE);
        for (int c = 0; c < NB; ++c) {
          tma_load(sk + s * TILE + c * BOX_BYTES, &map_k, bar_full + 8 * s,
                   64 * c, h, i * BK, b);
          tma_load(sv + s * TILE + c * BOX_BYTES, &map_v, bar_full + 8 * s,
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

  mbar_wait(bar_fix, 0);
  // D of rows r0 and r0 + 8 in f32 (rows past Tq are TMA's zeros), and
  // their lse in log2 units, +inf past Tq so that P is 0 there
  float d0 = row_dot<D>(gbase + (sdo - base), gbase + (so - base), r0,
                        lane % 4);
  float d1 = row_dot<D>(gbase + (sdo - base), gbase + (so - base), r0 + 8,
                        lane % 4);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, off);
    d1 += __shfl_xor_sync(0xffffffffu, d1, off);
  }
  const int64_t row0 = (int64_t)bh * Tq + q0;
  const bool in0 = q0 + r0 < Tq, in1 = q0 + r0 + 8 < Tq;
  const float l0 = in0 ? lse[row0 + r0] * kLog2e : kInf;
  const float l1 = in1 ? lse[row0 + r0 + 8] * kLog2e : kInf;
  if (lane % 4 == 0) {
    if (in0) dsum_out[row0 + r0] = d0;
    if (in1) dsum_out[row0 + r0 + 8] = d1;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  for (int i = 0; i < n_kt; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BK;
    const uint32_t kt = sk + s * TILE, vt = sv + s * TILE;
    mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);

    // S = Q K^T and dP = dO V^T: D/16 steps of k16 along the 128-byte
    // swizzled rows, as the forward's S.  The first step overwrites the
    // accumulators (scale-d 0), so they need no zeroing: registers the
    // code writes between the fence and a wgmma make ptxas serialize
    // every wgmma of the kernel
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss_m64n64(sc, desc(sq + off, 16, 1024),
                      desc(kt + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss_m64n64(dp, desc(sdo + off, 16, 1024),
                      desc(vt + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);
    pin(dp);

    // dS = P (dP - D) as the bf16 A operand of dS K, P = exp2(S * scale *
    // log2 e - lse * log2 e); masked only where some key is past Tk or
    // above the diagonal: entry idx lies at column k0 + cl + off(idx), off
    // = 8 * (idx / 4) + (idx & 1), masked past m0 (row r0) or m1 (r0 + 8).
    // k-step kk takes key columns 16*kk .. 16*kk+15, accumulator entries
    // 8*kk .. 8*kk+7 (as P in the forward's P V)
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + shift);
    int m0 = Tk - 1 - k0 - cl, m1 = m0;
    if (causal) {
      m0 = min(m0, q0 + r0 + shift - k0 - cl);
      m1 = min(m1, q0 + r0 + 8 + shift - k0 - cl);
    }
    uint32_t da[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = 8 * kk + e;
        const bool lo = !(e & 2);  // row r0 (else r0 + 8)
        float p = exp2_ftz(sc[idx] * scale_log2 - (lo ? l0 : l1));
        if (edge && 8 * (idx / 4) + (idx & 1) > (lo ? m0 : m1)) p = 0.f;
        x[e] = p * (dp[idx] - (lo ? d0 : d1));
      }
      da[4 * kk + 0] = pack_bf16(x[0], x[1]);
      da[4 * kk + 1] = pack_bf16(x[2], x[3]);
      da[4 * kk + 2] = pack_bf16(x[4], x[5]);
      da[4 * kk + 3] = pack_bf16(x[6], x[7]);
    }

    // dQ += dS K: K (BK x D, D contiguous) is the MN-major B operand, as
    // V in the forward's P V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(dq, da + 4 * kk, desc(kt + kk * 2048, BOX_BYTES, 1024));
    wgmma_commit();
    wgmma_wait_all();
    pin(dq);
    mbar_arrive(bar_empty + 8 * s);  // this thread is done with stage s
  }

  // epilogue: dQ * scale staged in O's tile (every warp has read O), then
  // one TMA store that clips rows past Tq
  consumer_sync();
  stage_tile<D>(gbase + (so - base), dq, sm_scale, r0, lane);
  // make the generic-proxy writes visible to the TMA (async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumer_sync();
  if (tid == 0) {
    for (int c = 0; c < NB; ++c)
      tma_store(&map_dq, so + c * BOX_BYTES, 64 * c, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // the shared memory must outlive the store's reads
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// (b) dK and dV for one (b*h, 64-row k tile).
template <int D>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 3 : 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_dk,
                    const __grid_constant__ CUtensorMap map_dv,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, int H, int BH, int Tq,
                    int Tk, float scale_log2, float sm_scale, int causal) {
  constexpr int NB = D / 64;
  constexpr uint32_t TILE = NB * BOX_BYTES;
  // q rows of one pass of the products (the registers of S^T and dP^T
  // beside dK and dV): the N of their m64n32k16
  constexpr int NQ = 32;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sk = base, sv = sk + TILE;
  const uint32_t sq = sv + TILE;                // [STAGES]
  const uint32_t sdo = sq + STAGES * TILE;      // [STAGES]
  const uint32_t sst = sdo + STAGES * TILE;     // [STAGES][2][64] floats
  float* const stats = reinterpret_cast<float*>(gbase + (sst - base));
  const uint32_t bar_fix = sst + STAGES * 2 * 64 * sizeof(float);  // K, V
  const uint32_t bar_full = bar_fix + 8;        // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  // the first k tiles see the most causal q rows: they go first
  const int kt = (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int k0 = kt * BK;
  const int shift = Tk - Tq;
  // q rows before position k0 - shift see none of these keys
  const int qt0 = causal ? max(0, k0 - shift) / BQ : 0;
  const int n_it = max(0, (Tq + BQ - 1) / BQ - qt0);
  const float kInf = __int_as_float(0x7f800000);

  if (threadIdx.x == 0) {
    mbar_init(bar_fix, 1);
    for (int s = 0; s < STAGES; ++s) {
      // the producer's lane 0 arrives with the expected bytes, then each
      // of its 32 lanes once its lse and D values are written
      mbar_init(bar_full + 8 * s, 1 + 32);
      mbar_init(bar_empty + 8 * s, NCONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NCONSUMER) {
    // producer warp: lane 0 issues the copies; every lane stages two of
    // each tile's 64 lse (in log2 units, +inf past Tq) and D values
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(bar_fix, 2 * TILE);
      for (int c = 0; c < NB; ++c) {
        tma_load(sk + c * BOX_BYTES, &map_k, bar_fix, 64 * c, h, k0, b);
        tma_load(sv + c * BOX_BYTES, &map_v, bar_fix, 64 * c, h, k0, b);
      }
    }
    const float* lrow = lse + (int64_t)bh * Tq;
    const float* drow = dsum + (int64_t)bh * Tq;
    for (int i = 0; i < n_it; ++i) {
      const int s = i % STAGES;
      const int q0 = (qt0 + i) * BQ;
      mbar_wait(bar_empty + 8 * s, ((i / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bar_full + 8 * s, 2 * TILE);
        for (int c = 0; c < NB; ++c) {
          tma_load(sq + s * TILE + c * BOX_BYTES, &map_q, bar_full + 8 * s,
                   64 * c, h, q0, b);
          tma_load(sdo + s * TILE + c * BOX_BYTES, &map_do, bar_full + 8 * s,
                   64 * c, h, q0, b);
        }
      }
      float* st = stats + s * 128;
      for (int r = lane; r < BQ; r += 32) {
        const int row = q0 + r;
        st[r] = row < Tq ? lrow[row] * kLog2e : kInf;
        st[64 + r] = row < Tq ? drow[row] : 0.f;
      }
      mbar_arrive(bar_full + 8 * s);
    }
    return;
  }

  // consumer warpgroup: rows of the accumulators are keys, columns q rows
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;
  const int cl = 2 * (lane % 4);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar_fix, 0);
  for (int i = 0; i < n_it; ++i) {
    const int s = i % STAGES;
    const int q0 = (qt0 + i) * BQ;
    const uint32_t qtile = sq + s * TILE, otile = sdo + s * TILE;
    const float* st = stats + s * 128;
    mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
    // mask only where some key is past Tk or some q row lies before a
    // key; rows past Tq have lse = +inf, so their P is 0 already
    const bool edge = k0 + BK > Tk || (causal && q0 + shift < k0 + BK - 1);
#pragma unroll
    for (int pass = 0; pass < BQ / NQ; ++pass) {
      const uint32_t rows = pass * NQ * 128;  // the pass's first q row
      // entry e lies at q column q0 + pass * NQ + cl + off(e), off = 8 *
      // (e / 4) + (e & 1): masked below m0 (key k0 + r0) or m1 (key
      // k0 + r0 + 8), and everywhere for a key past Tk
      const int c0 = q0 + pass * NQ + cl + shift;
      int m0 = causal ? k0 + r0 - c0 : INT_MIN, m1 = causal ? m0 + 8 : INT_MIN;
      if (k0 + r0 >= Tk) m0 = INT_MAX;
      if (k0 + r0 + 8 >= Tk) m1 = INT_MAX;
      // S^T = K Q^T and dP^T = V dO^T over the pass's NQ q rows (the
      // first step overwrites the accumulators, as in (a))
      float sc[NQ / 2], dp[NQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        wgmma_ss_m64n32(sc, desc(sk + off, 16, 1024),
                        desc(qtile + rows + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        wgmma_ss_m64n32(dp, desc(sv + off, 16, 1024),
                        desc(otile + rows + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      pin(dp);

      // P^T and dS^T = P^T (dP^T - D) as bf16 A operands, lse and D
      // indexed by the column (the q row)
      uint32_t pa[NQ / 4], da[NQ / 4];
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk) {
        float p[8], x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int idx = 8 * kk + e;
          const int c = pass * NQ + 8 * (idx / 4) + cl + (e & 1);
          float pv = exp2_ftz(sc[idx] * scale_log2 - st[c]);
          if (edge && 8 * (idx / 4) + (idx & 1) < ((e & 2) ? m1 : m0))
            pv = 0.f;
          p[e] = pv;
          x[e] = pv * (dp[idx] - st[64 + c]);
        }
        pa[4 * kk + 0] = pack_bf16(p[0], p[1]);
        pa[4 * kk + 1] = pack_bf16(p[2], p[3]);
        pa[4 * kk + 2] = pack_bf16(p[4], p[5]);
        pa[4 * kk + 3] = pack_bf16(p[6], p[7]);
        da[4 * kk + 0] = pack_bf16(x[0], x[1]);
        da[4 * kk + 1] = pack_bf16(x[2], x[3]);
        da[4 * kk + 2] = pack_bf16(x[4], x[5]);
        da[4 * kk + 3] = pack_bf16(x[6], x[7]);
      }

      // dV += P^T dO and dK += dS^T Q: dO and Q (q rows x D) are the
      // MN-major B operands; k-step kk reads the pass's q rows 16*kk ..
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk) {
        wgmma_pv<D>(dv, pa + 4 * kk,
                    desc(otile + rows + kk * 2048, BOX_BYTES, 1024));
        wgmma_pv<D>(dk, da + 4 * kk,
                    desc(qtile + rows + kk * 2048, BOX_BYTES, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(dk);
      pin(dv);
    }
    mbar_arrive(bar_empty + 8 * s);
  }

  // epilogue: dK * scale and dV staged in K's and V's tiles (every
  // warp's last wgmma has read them), then TMA stores that clip rows
  // past Tk
  consumer_sync();
  stage_tile<D>(gbase, dk, sm_scale, r0, lane);
  stage_tile<D>(gbase + (sv - base), dv, 1.f, r0, lane);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumer_sync();
  if (tid == 0) {
    for (int c = 0; c < NB; ++c) {
      tma_store(&map_dk, sk + c * BOX_BYTES, 64 * c, h, k0, b);
      tma_store(&map_dv, sv + c * BOX_BYTES, 64 * c, h, k0, b);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// maps: 8 x 11 numbers (see make_map), those of q, k, v, o, dO, dq, dk
// and dv
template <int D>
int launch(const Args& a, const long long* maps, float sm_scale,
           cudaStream_t stream) {
  auto kq = flash_bwd_dq_wgmma<D>;
  auto kkv = flash_bwd_dkv_wgmma<D>;
  static std::atomic<unsigned long long> attr_q{0}, attr_kv{0};
  int err = allow_smem(kq, dq_smem_bytes<D>(), attr_q);
  if (err != 0) return err;
  err = allow_smem(kkv, dkv_smem_bytes<D>(), attr_kv);
  if (err != 0) return err;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  const void* ptrs[8] = {a.q, a.k, a.v, a.o, a.dout, a.dq, a.dk, a.dv};
  CUtensorMap m[8];
  for (int i = 0; i < 8; ++i)
    if ((err = make_map(&m[i], encode, ptrs[i], maps + 11 * i)) != 0)
      return err;
  const int BH = a.B * a.H;
  const int n_qtiles = (a.Tq + BQ - 1) / BQ;
  const int n_ktiles = (a.Tk + BK - 1) / BK;
  const float scale_log2 = sm_scale * kLog2e;
  kq<<<(unsigned)n_qtiles * (unsigned)BH, NTHREADS, dq_smem_bytes<D>(),
       stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], a.lse, a.dsum, a.H, BH,
                 n_qtiles, a.Tq, a.Tk, scale_log2, sm_scale, a.causal);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  // reads the D rows the first launch wrote (same stream)
  kkv<<<(unsigned)n_ktiles * (unsigned)BH, NTHREADS, dkv_smem_bytes<D>(),
        stream>>>(m[0], m[1], m[2], m[4], m[6], m[7], a.lse, a.dsum, a.H,
                  BH, a.Tq, a.Tk, scale_log2, sm_scale, a.causal);
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace

// The C interface: every integer argument in one packed int64 array,
// returning a cudaError_t (0 when both launches were accepted).  Both
// entries start with the same 19 numbers:
//   q, k, v, o, dO, lse, D scratch, dq, dk, dv (device pointers; lse and
//   the (B, H, Tq) D scratch are float32), B, H, Tq, Tk, D, causal,
//   stream, device, dtype (0 = float32, 1 = bfloat16)
enum { A_Q, A_K, A_V, A_O, A_DO, A_LSE, A_DSUM, A_DQ, A_DK, A_DV, A_B, A_H,
       A_TQ, A_TK, A_D, A_CAUSAL, A_STREAM, A_DEVICE, A_DTYPE, A_HEAD };

namespace {
// Read the head; false on values the kernels cannot take.
bool parse(const long long* a, Args& g) {
  g.q = (const void*)a[A_Q];
  g.k = (const void*)a[A_K];
  g.v = (const void*)a[A_V];
  g.o = (const void*)a[A_O];
  g.dout = (const void*)a[A_DO];
  g.lse = (const float*)a[A_LSE];
  g.dsum = (float*)a[A_DSUM];
  g.dq = (void*)a[A_DQ];
  g.dk = (void*)a[A_DK];
  g.dv = (void*)a[A_DV];
  g.B = (int)a[A_B];
  g.H = (int)a[A_H];
  g.Tq = (int)a[A_TQ];
  g.Tk = (int)a[A_TK];
  g.D = (int)a[A_D];
  g.causal = (int)a[A_CAUSAL];
  return g.D > 0 && g.D <= 128 && g.D % 8 == 0 && g.B > 0 && g.H > 0 &&
         g.Tq > 0 && g.Tk > 0;
}
}  // namespace

// SIMT kernels: float32 or bfloat16, any head dim the forward takes.
// After the head: 24 element strides, the (batch, seq, head) strides of
// q, k, v, o, dO, dq, dk and dv.
extern "C" int mxt_flash_attn_bwd(const long long* a, float sm_scale) {
  Args g;
  if (!parse(a, g)) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < N_STRIDES; ++i) st.s[i] = a[A_HEAD + i];
  DeviceGuard guard((int)a[A_DEVICE]);
  if (guard.err) return guard.err;
  cudaStream_t s = (cudaStream_t)a[A_STREAM];
  const long long dtype = a[A_DTYPE];
  if (dtype == 0)
    return g.D <= 64 ? launch<float, 64>(g, st, sm_scale, s)
                     : launch<float, 128>(g, st, sm_scale, s);
  if (dtype == 1)
    return g.D <= 64 ? launch<__nv_bfloat16, 64>(g, st, sm_scale, s)
                     : launch<__nv_bfloat16, 128>(g, st, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

// wgmma kernels: bfloat16 with D = 64 or 128.  After the head: 8 x 11
// numbers, the TMA map arguments of q, k, v, o, dO, dq, dk and dv (the
// wrapper checks that TMA can read and write each).
extern "C" int mxt_flash_attn_bwd_wgmma(const long long* a, float sm_scale) {
  Args g;
  if (!parse(a, g) || a[A_DTYPE] != 1 || (g.D != 64 && g.D != 128))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard((int)a[A_DEVICE]);
  if (guard.err) return guard.err;
  cudaStream_t s = (cudaStream_t)a[A_STREAM];
  const long long* maps = a + A_HEAD;
  return g.D == 64 ? wg::launch<64>(g, maps, sm_scale, s)
                   : wg::launch<128>(g, maps, sm_scale, s);
}
