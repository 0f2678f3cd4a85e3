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
//   (a) the dq kernel, one block a (b*h, 64-row q tile): D for its rows
//       (written to a scratch (B, H, Tq) buffer), then a loop over the
//       k/v tiles up to the causal limit accumulating dQ;
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
// (1) `tc` (`flash_bwd_dq_mma` / `flash_bwd_dkv_mma`): bf16 with D = 64
//     or 128 and 16-byte aligned rows, the training path.  Four warps a
//     block, 16 of its rows each; the products run on the tensor cores
//     through `mma.sync` m16n8k16 (bf16 operands, f32 accumulators) with
//     operands fetched from padded shared-memory tiles by `ldmatrix`
//     (`.trans` where the operand is stored k-major); P and dS go from
//     the accumulator layout straight into the A operand of the next
//     product, rounded to bf16 there as FlashAttention-2 does.  Tiles are
//     loaded with 16-byte vector loads and no pipelining: the simple
//     version; `wgmma` fed by TMA with the loads overlapped, as the
//     forward does, is the follow-up (ROADMAP B1).
// (2) SIMT (`flash_bwd_dq` / `flash_bwd_dkv`): float32, and bf16 with any
//     other head dim or alignment.  Scalar f32 FMAs from f32 shared-memory
//     tiles, P and dS kept in f32: bound by the CUDA cores (67 TFLOP/s)
//     and their shared-memory loads, about one a two FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

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

// Raise a kernel's dynamic shared-memory limit once per device (the
// attribute outlives the launch), not on every launch.
template <typename K>
int allow_smem(K kern, size_t bytes,
               std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return 0;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  done.fetch_or(bit, std::memory_order_relaxed);
  return 0;
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

struct DeviceGuard {
  int prev = -1, err = 0;
  explicit DeviceGuard(int dev) {
    int cur = 0;
    err = (int)cudaGetDevice(&cur);
    if (err == 0 && cur != dev) {
      err = (int)cudaSetDevice(dev);
      if (err == 0) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// (1) tc: bf16, D = 64 or 128, 16-byte aligned rows, on the tensor cores
// ---------------------------------------------------------------------------
namespace {
namespace tc {

constexpr int NTHREADS = 128;   // four warps, 16 rows of the block's tile each
constexpr int BROWS = 64;       // the block's own rows (q in dq, k in dk/dv)

// the tile of the other side streamed through the loop: 64 rows at
// D = 64, 32 at D = 128 (the registers of the dk/dv accumulators)
template <int D>
__host__ __device__ constexpr int bstream() { return D == 64 ? 64 : 32; }
// padded bf16 row: the 8 rows an ldmatrix reads fall on distinct banks
template <int D>
__host__ __device__ constexpr int ldb() { return D + 8; }

template <int D>
constexpr size_t smem_bytes() {
  // two BROWS-row tiles, two streamed tiles (bf16), 2 x 64 floats
  return (size_t)(2 * BROWS + 2 * bstream<D>()) * ldb<D>() * 2 +
         2 * 64 * sizeof(float);
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
               "%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment (16 x 16) at (r0, c0) of a row-major smem tile.
template <int D>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint16_t* t,
                                       int r0, int c0) {
  const int l = threadIdx.x % 32, m = l / 8;
  ldsm_x4(a, saddr(t + (r0 + l % 8 + (m & 1) * 8) * ldb<D>() + c0 +
                   (m >> 1) * 8));
}

// B fragments of two n8 tiles (n0, n0 + 8) x k16 at k0, from a smem tile
// stored [n][k] (row n, k contiguous): b[0..1] the first, b[2..3] the
// second.
template <int D>
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const uint16_t* t,
                                          int n0, int k0) {
  const int l = threadIdx.x % 32, m = l / 8;
  ldsm_x4(b, saddr(t + (n0 + l % 8 + (m >> 1) * 8) * ldb<D>() + k0 +
                   (m & 1) * 8));
}

// The same from a smem tile stored [k][n] (row k, n contiguous), loaded
// transposed.
template <int D>
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const uint16_t* t,
                                          int k0, int n0) {
  const int l = threadIdx.x % 32, m = l / 8;
  ldsm_x4_t(b, saddr(t + (k0 + l % 8 + (m & 1) * 8) * ldb<D>() + n0 +
                     (m >> 1) * 8));
}

// Stage rows [r0, r0 + nrows) of one (T, D) bf16 head slice into a padded
// smem tile, 16 bytes a thread, zeros past T.
template <int D>
__device__ __forceinline__ void load_rows(uint16_t* dst, const uint16_t* src,
                                          int64_t row_stride, int r0,
                                          int nrows, int T_len) {
  constexpr int VPR = D / 8;
  for (int idx = threadIdx.x; idx < nrows * VPR; idx += NTHREADS) {
    const int r = idx / VPR, c = idx % VPR;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T_len)
      v = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * row_stride +
                                          8 * c);
    *reinterpret_cast<uint4*>(dst + r * ldb<D>() + 8 * c) = v;
  }
}

// s = A B^T and dp = A2 B2^T for this warp's 16 rows (w16 of the A
// tiles) against NB rows of the B tiles, over D: NB/8 n8 tiles.
template <int D, int NB>
__device__ __forceinline__ void products(const uint16_t* sA,
                                         const uint16_t* sB,
                                         const uint16_t* sA2,
                                         const uint16_t* sB2, int w16,
                                         float (&s)[NB / 8][4],
                                         float (&dp)[NB / 8][4]) {
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], a2[4];
    frag_a<D>(a, sA, w16, 16 * kk);
    frag_a<D>(a2, sA2, w16, 16 * kk);
#pragma unroll
    for (int n2 = 0; n2 < NB / 16; ++n2) {
      uint32_t b[4];
      frag_b_nk<D>(b, sB, 16 * n2, 16 * kk);
      mma(s[2 * n2], a, b[0], b[1]);
      mma(s[2 * n2 + 1], a, b[2], b[3]);
      frag_b_nk<D>(b, sB2, 16 * n2, 16 * kk);
      mma(dp[2 * n2], a2, b[0], b[1]);
      mma(dp[2 * n2 + 1], a2, b[2], b[3]);
    }
  }
}

// acc (16 x D) += P (16 x NB, the accumulator fragments of products())
// times the NB x D smem tile t stored [k][d].
template <int D, int NB>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&p)[NB / 8][4],
                                           const uint16_t* t) {
#pragma unroll
  for (int kc = 0; kc < NB / 16; ++kc) {
    const uint32_t a[4] = {pack(p[2 * kc][0], p[2 * kc][1]),
                           pack(p[2 * kc][2], p[2 * kc][3]),
                           pack(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           pack(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];
      frag_b_kn<D>(b, t, 16 * kc, 16 * n2);
      mma(acc[2 * n2], a, b[0], b[1]);
      mma(acc[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// Write this warp's 16 x D accumulator rows (row0 + g, + 8) times scale.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int64_t stride,
                                           int row0, int T_len,
                                           const float (&acc)[D / 8][4],
                                           float scale) {
  const int l = threadIdx.x % 32, g = l / 4, c = 2 * (l % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= T_len) continue;
    __nv_bfloat16* o = out + (int64_t)row * stride + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * half] * scale, acc[j][2 * half + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, const uint16_t* __restrict__ o,
                 const uint16_t* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ dsum_out,
                 __nv_bfloat16* __restrict__ dq, int H, int BH, int n_qtiles,
                 int Tq, int Tk, const Strides st, float sm_scale,
                 int causal) {
  constexpr int NB = bstream<D>(), LD = ldb<D>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sdO = sQ + BROWS * LD;
  uint16_t* sK = sdO + BROWS * LD;
  uint16_t* sV = sK + NB * LD;
  float* sD = reinterpret_cast<float*>(sV + NB * LD);
  float* sL = sD + 64;

  const int qt = n_qtiles - 1 - (int)(blockIdx.x / BH);  // heaviest first
  const int bh = (int)(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BROWS;
  const int shift = Tk - Tq;
  const int64_t row0 = (int64_t)bh * Tq;
  const uint16_t* qh = q + b * st.s[S_Q] + h * st.s[S_Q + 2];
  const uint16_t* kh = k + b * st.s[S_K] + h * st.s[S_K + 2];
  const uint16_t* vh = v + b * st.s[S_V] + h * st.s[S_V + 2];
  const uint16_t* oh = o + b * st.s[S_O] + h * st.s[S_O + 2];
  const uint16_t* doh = dout + b * st.s[S_DO] + h * st.s[S_DO + 2];

  load_rows<D>(sQ, qh, st.s[S_Q + 1], q0, BROWS, Tq);
  load_rows<D>(sdO, doh, st.s[S_DO + 1], q0, BROWS, Tq);
  {
    // D = rowsum(dO * O) in f32: two threads a row, O read from global
    const int r = threadIdx.x / 2, part = threadIdx.x % 2;
    float acc = 0.f;
    if (q0 + r < Tq) {
      const uint16_t* orow = oh + (int64_t)(q0 + r) * st.s[S_O + 1];
      const uint16_t* drow = doh + (int64_t)(q0 + r) * st.s[S_DO + 1];
      for (int d = part * (D / 2); d < (part + 1) * (D / 2); ++d)
        acc = fmaf(__bfloat162float(__ushort_as_bfloat16(orow[d])),
                   __bfloat162float(__ushort_as_bfloat16(drow[d])), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      sD[r] = acc;
      sL[r] = q0 + r < Tq ? lse[row0 + q0 + r] : 0.f;
      if (q0 + r < Tq) dsum_out[row0 + q0 + r] = acc;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int g = l / 4, c = 2 * (l % 4);
  const int w16 = 16 * warp;
  float lse_r[2], d_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    lse_r[half] = sL[w16 + g + 8 * half];
    d_r[half] = sD[w16 + g + 8 * half];
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int k_end = Tk;
  if (causal) k_end = min(Tk, min(q0 + BROWS, Tq) + shift);
  for (int k0 = 0; k0 < k_end; k0 += NB) {
    __syncthreads();  // the previous K/V tiles fully read
    load_rows<D>(sK, kh, st.s[S_K + 1], k0, NB, Tk);
    load_rows<D>(sV, vh, st.s[S_V + 1], k0, NB, Tk);
    __syncthreads();
    float s[NB / 8][4], ds[NB / 8][4];
    products<D, NB>(sQ, sK, sdO, sV, w16, s, ds);
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + w16 + g + ((e & 2) ? 8 : 0);
        const int key = k0 + 8 * j + c + (e & 1);
        const bool ok = row < Tq && key < Tk && (!causal || row + shift >= key);
        const float p = ok ? expf(s[j][e] * sm_scale - lse_r[e >> 1]) : 0.f;
        ds[j][e] = p * (ds[j][e] - d_r[e >> 1]);
      }
    accumulate<D, NB>(acc, ds, sK);
  }
  store_rows<D>(dq + b * st.s[S_DQ] + h * st.s[S_DQ + 2], st.s[S_DQ + 1],
                q0 + w16, Tq, acc, sm_scale);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_mma(const uint16_t* __restrict__ q,
                  const uint16_t* __restrict__ k,
                  const uint16_t* __restrict__ v,
                  const uint16_t* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum_in,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int H, int BH, int Tq,
                  int Tk, const Strides st, float sm_scale, int causal) {
  constexpr int NB = bstream<D>(), LD = ldb<D>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sV = sK + BROWS * LD;
  uint16_t* sQ = sV + BROWS * LD;
  uint16_t* sdO = sQ + NB * LD;
  float* sL = reinterpret_cast<float*>(sdO + NB * LD);
  float* sD = sL + 64;

  const int kt = (int)(blockIdx.x / BH);  // the first k tiles see most rows
  const int bh = (int)(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int k0 = kt * BROWS;
  const int shift = Tk - Tq;
  const int64_t row0 = (int64_t)bh * Tq;
  const uint16_t* qh = q + b * st.s[S_Q] + h * st.s[S_Q + 2];
  const uint16_t* kh = k + b * st.s[S_K] + h * st.s[S_K + 2];
  const uint16_t* vh = v + b * st.s[S_V] + h * st.s[S_V + 2];
  const uint16_t* doh = dout + b * st.s[S_DO] + h * st.s[S_DO + 2];

  load_rows<D>(sK, kh, st.s[S_K + 1], k0, BROWS, Tk);
  load_rows<D>(sV, vh, st.s[S_V + 1], k0, BROWS, Tk);

  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int g = l / 4, c = 2 * (l % 4);
  const int w16 = 16 * warp;
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - shift) / NB * NB;  // rows before see none
  for (int q0 = q_begin; q0 < Tq; q0 += NB) {
    __syncthreads();  // the previous Q/dO tiles fully read
    load_rows<D>(sQ, qh, st.s[S_Q + 1], q0, NB, Tq);
    load_rows<D>(sdO, doh, st.s[S_DO + 1], q0, NB, Tq);
    if (threadIdx.x < NB) {
      const int row = q0 + threadIdx.x;
      sL[threadIdx.x] = row < Tq ? lse[row0 + row] : 0.f;
      sD[threadIdx.x] = row < Tq ? dsum_in[row0 + row] : 0.f;
    }
    __syncthreads();
    // S^T (keys x q) and dP^T = V dO^T for this warp's 16 keys
    float p[NB / 8][4], ds[NB / 8][4];
    products<D, NB>(sK, sQ, sV, sdO, w16, p, ds);
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + w16 + g + ((e & 2) ? 8 : 0);
        const int qi = 8 * j + c + (e & 1);
        const int row = q0 + qi;
        const bool ok = row < Tq && key < Tk && (!causal || row + shift >= key);
        const float pv = ok ? expf(p[j][e] * sm_scale - sL[qi]) : 0.f;
        p[j][e] = pv;
        ds[j][e] = pv * (ds[j][e] - sD[qi]);
      }
    accumulate<D, NB>(acc_v, p, sdO);
    accumulate<D, NB>(acc_k, ds, sQ);
  }
  store_rows<D>(dk + b * st.s[S_DK] + h * st.s[S_DK + 2], st.s[S_DK + 1],
                k0 + w16, Tk, acc_k, sm_scale);
  store_rows<D>(dv + b * st.s[S_DV] + h * st.s[S_DV + 2], st.s[S_DV + 1],
                k0 + w16, Tk, acc_v, 1.f);
}

template <int D>
int launch(const Args& a, const Strides& st, float sm_scale,
           cudaStream_t stream) {
  auto kq = flash_bwd_dq_mma<D>;
  auto kkv = flash_bwd_dkv_mma<D>;
  static std::atomic<unsigned long long> attr_q{0}, attr_kv{0};
  int err = allow_smem(kq, smem_bytes<D>(), attr_q);
  if (err != 0) return err;
  err = allow_smem(kkv, smem_bytes<D>(), attr_kv);
  if (err != 0) return err;
  const int BH = a.B * a.H;
  const int n_qtiles = (a.Tq + BROWS - 1) / BROWS;
  const int n_ktiles = (a.Tk + BROWS - 1) / BROWS;
  kq<<<(unsigned)n_qtiles * (unsigned)BH, NTHREADS, smem_bytes<D>(),
       stream>>>((const uint16_t*)a.q, (const uint16_t*)a.k,
                 (const uint16_t*)a.v, (const uint16_t*)a.o,
                 (const uint16_t*)a.dout, a.lse, a.dsum,
                 (__nv_bfloat16*)a.dq, a.H, BH, n_qtiles, a.Tq, a.Tk, st,
                 sm_scale, a.causal);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  kkv<<<(unsigned)n_ktiles * (unsigned)BH, NTHREADS, smem_bytes<D>(),
        stream>>>((const uint16_t*)a.q, (const uint16_t*)a.k,
                  (const uint16_t*)a.v, (const uint16_t*)a.dout, a.lse,
                  a.dsum, (__nv_bfloat16*)a.dk, (__nv_bfloat16*)a.dv, a.H,
                  BH, a.Tq, a.Tk, st, sm_scale, a.causal);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

// The C interface: every integer argument in one packed int64 array,
// returning a cudaError_t (0 when both launches were accepted):
//   q, k, v, o, dO, lse, D scratch, dq, dk, dv (device pointers; lse and
//   the (B, H, Tq) D scratch are float32), B, H, Tq, Tk, D, causal,
//   stream, device, dtype (0 = float32, 1 = bfloat16), then 24 element
//   strides: the (batch, seq, head) strides of q, k, v, o, dO, dq, dk
//   and dv.
enum { A_Q, A_K, A_V, A_O, A_DO, A_LSE, A_DSUM, A_DQ, A_DK, A_DV, A_B, A_H,
       A_TQ, A_TK, A_D, A_CAUSAL, A_STREAM, A_DEVICE, A_DTYPE, A_HEAD };

namespace {
// Read the packed arguments; false on values the kernels cannot take.
bool parse(const long long* a, Args& g, Strides& st) {
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
  for (int i = 0; i < N_STRIDES; ++i) st.s[i] = a[A_HEAD + i];
  return g.D > 0 && g.D <= 128 && g.D % 8 == 0 && g.B > 0 && g.H > 0 &&
         g.Tq > 0 && g.Tk > 0;
}
}  // namespace

// SIMT kernels: float32 or bfloat16, any head dim the forward takes.
extern "C" int mxt_flash_attn_bwd(const long long* a, float sm_scale) {
  Args g;
  Strides st;
  if (!parse(a, g, st)) return (int)cudaErrorInvalidValue;
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

// Tensor-core kernels: bfloat16 with D = 64 or 128, every row of q, k,
// v, o and dO 16-byte aligned (the wrapper checks).
extern "C" int mxt_flash_attn_bwd_mma(const long long* a, float sm_scale) {
  Args g;
  Strides st;
  if (!parse(a, g, st) || a[A_DTYPE] != 1 || (g.D != 64 && g.D != 128))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard((int)a[A_DEVICE]);
  if (guard.err) return guard.err;
  cudaStream_t s = (cudaStream_t)a[A_STREAM];
  return g.D == 64 ? tc::launch<64>(g, st, sm_scale, s)
                   : tc::launch<128>(g, st, sm_scale, s);
}
