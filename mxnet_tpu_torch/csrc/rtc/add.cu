// Elementwise o = x + y, written for Hopper and compiled at run time by
// NVRTC (mxnet_tpu_torch/rtc.py CudaModule, --gpu-architecture=sm_90a).
//
// Replaces: the Pallas `add` kernel of tests/test_parity_tail.py:148-156
// (`add_kernel` under one pl.pallas_call over the whole array), which the
// JAX package launches through mxnet_tpu/rtc.py:20-72
// (PallasModule / PallasKernel.launch).  Like that kernel it takes two
// arrays of one shape and dtype and writes a third; the host passes the
// element count n and picks the grid.
//
// Bound: bytes.  Each element is read twice and written once (12 bytes
// in float32, 6 in bfloat16) for one add, far below the card's 295
// operations a byte, so the least time is 3 * n * sizeof(T) over the
// memory rate (3.35 TB/s).  Design: a grid-stride loop, so any grid
// covers any n; 16-byte vector loads and stores (4 floats, or 8 bfloat16
// values) when all three pointers are 16-byte aligned, which PyTorch's
// allocations are, then a scalar tail for the last n % 4 (or n % 8)
// elements.  Unaligned pointers (an offset view) take the scalar loop.
// To keep more bytes in flight against HBM's latency, each thread loads
// UNROLL vectors of x and UNROLL of y (the grid stride apart) before its
// first add, and stores with st.global.cs (evict-first), so the output
// does not displace the inputs in L2.  Measured on an H100 at 2**26
// float32 on a grid of at most 8 blocks of 256 an SM, this is 7-9 %
// slower than torch.add and no faster than one vector a thread at a
// time (PERF.md): the unrolled loop does not close that gap.
//
// No headers: NVRTC needs none for this file (the 16-byte vectors are
// plain aligned structs, the streaming store is inline PTX).  bfloat16
// travels as its 16-bit pattern; each sum is taken in float32 and
// rounded to nearest even, as PyTorch's bfloat16 add does.

#define UNROLL 4

struct alignas(16) F4 { float a, b, c, d; };
struct alignas(16) U4 { unsigned int a, b, c, d; };

__device__ __forceinline__ bool aligned16(const void* x, const void* y,
                                          const void* out) {
  return ((reinterpret_cast<unsigned long long>(x) |
           reinterpret_cast<unsigned long long>(y) |
           reinterpret_cast<unsigned long long>(out)) & 15) == 0;
}

__device__ __forceinline__ void store_cs(F4* p, const F4& v) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(v.a), "f"(v.b), "f"(v.c), "f"(v.d) : "memory");
}

__device__ __forceinline__ void store_cs(U4* p, const U4& v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.a), "r"(v.b), "r"(v.c), "r"(v.d) : "memory");
}

__device__ __forceinline__ float bf16_to_float(unsigned short h) {
  return __uint_as_float(((unsigned int)h) << 16);
}

__device__ __forceinline__ unsigned short float_to_bf16(float f) {
  unsigned int u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;  // NaN, as c10
  u += 0x7fffu + ((u >> 16) & 1u);  // round to nearest, ties to even
  return (unsigned short)(u >> 16);
}

__device__ __forceinline__ unsigned int add_bf16x2(unsigned int a,
                                                   unsigned int b) {
  const unsigned short lo = float_to_bf16(bf16_to_float(a & 0xffffu) +
                                          bf16_to_float(b & 0xffffu));
  const unsigned short hi = float_to_bf16(bf16_to_float(a >> 16) +
                                          bf16_to_float(b >> 16));
  return (unsigned int)lo | ((unsigned int)hi << 16);
}

__device__ __forceinline__ F4 vadd(const F4& a, const F4& b) {
  return F4{a.a + b.a, a.b + b.b, a.c + b.c, a.d + b.d};
}

__device__ __forceinline__ U4 vadd(const U4& a, const U4& b) {
  return U4{add_bf16x2(a.a, b.a), add_bf16x2(a.b, b.b),
            add_bf16x2(a.c, b.c), add_bf16x2(a.d, b.d)};
}

// o[i] = x[i] + y[i] for the nv 16-byte vectors, this thread's share of
// a grid stride loop: UNROLL strides at a time, then one at a time
template <typename V>
__device__ __forceinline__ void add_vectors(const V* __restrict__ x,
                                            const V* __restrict__ y,
                                            V* __restrict__ o, long long nv,
                                            long long i, long long stride) {
  for (; i + (UNROLL - 1) * stride < nv; i += UNROLL * stride) {
    V a[UNROLL], b[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) a[u] = x[i + u * stride];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) b[u] = y[i + u * stride];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) store_cs(o + i + u * stride,
                                              vadd(a[u], b[u]));
  }
  for (; i < nv; i += stride) store_cs(o + i, vadd(x[i], y[i]));
}

extern "C" __global__ void add(const float* __restrict__ x,
                               const float* __restrict__ y,
                               float* __restrict__ out, long long n) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = aligned16(x, y, out) ? n / 4 : 0;
  add_vectors(reinterpret_cast<const F4*>(x), reinterpret_cast<const F4*>(y),
              reinterpret_cast<F4*>(out), n4, tid, stride);
  for (long long i = n4 * 4 + tid; i < n; i += stride) out[i] = x[i] + y[i];
}

extern "C" __global__ void add_bf16(const unsigned short* __restrict__ x,
                                    const unsigned short* __restrict__ y,
                                    unsigned short* __restrict__ out,
                                    long long n) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n8 = aligned16(x, y, out) ? n / 8 : 0;
  add_vectors(reinterpret_cast<const U4*>(x), reinterpret_cast<const U4*>(y),
              reinterpret_cast<U4*>(out), n8, tid, stride);
  for (long long i = n8 * 8 + tid; i < n; i += stride)
    out[i] = float_to_bf16(bf16_to_float(x[i]) + bf16_to_float(y[i]));
}
