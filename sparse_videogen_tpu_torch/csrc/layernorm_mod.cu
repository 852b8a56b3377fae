// Row LayerNorm with an affine epilogue, bf16 in and out, f32 math, sm_90a:
//   out[b, s, :] = bf16( ((x - mu) * rsqrt(var + eps)) * m[b] + a[b] )
// mu and var the f32 mean and the mean of (x - mu)^2 over the row of d.
//
// Replaces no TPU kernel: the JAX package leaves the DiT blocks' f32
// LayerNorm + AdaLN modulation to XLA, which fuses it; on the card the port
// ran it as ~17 eager passes over f32 temporaries (PERF.md §5). The models
// call it at every `model.norm` site of Wan (norm1, norm2 with m = 1 + scale
// and a = shift; norm3 with its weight and bias; the head) and HunyuanVideo
// (every `_modulate`), through ops/layernorm_mod.py.
//
// What bounds it on the H100: device-memory bandwidth, one bf16 read of x
// and one bf16 write (4 bytes an element; m and a are a row each, read from
// L1/L2). Design: whole rows in registers as packed bf16, one 16-byte load
// per 8 elements, WPR warps a row (WPR the fewest of 1, 2, 4, 8 that hold
// the row in VPT <= 4 loads a thread: at most 56 registers, so 4 CTAs of 256
// threads an SM, 8 / WPR rows a CTA; 1-2% faster than one warp a row with
// up to 8 loads a thread at d = 1536 and 3072). The mean, then the mean of
// squared deviations (two passes over the registers, the eager formula; not
// E[x^2] - mu^2), each a butterfly of warp shuffles plus, for WPR > 1, a
// fixed-order sum of the row's warps in shared memory: every thread of a row
// gets the same bits. The epilogue's products and sums round separately
// (__fmul_rn / __fadd_rn, no FMA contraction), in the eager expression's
// order. One 16-byte store per 8 outputs. x is addressed as (B, S, d) with a
// batch stride and rows of d contiguous, so a batch of rows sliced out of a
// longer sequence needs no copy; m and a as (B, d) with a batch stride (0:
// one vector for all).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVpt = 4;

// The 8 f32 values of 8 packed bf16. The empty asm hides the words' value
// from the compiler, so each pass unpacks them anew and a vector holds 4
// registers across the passes, not 8 (more rows in flight per SM).
__device__ __forceinline__ void unpack8(uint4 raw, float (&f)[8]) {
  asm volatile("" : "+r"(raw.x), "+r"(raw.y), "+r"(raw.z), "+r"(raw.w));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

// The sum of v over the WPR warps of this thread's row, the same bits in
// every thread of the row. Every thread of the CTA calls it (it may sync).
template <int WPR>
__device__ __forceinline__ float row_sum(float v, float* red, int warp, int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (WPR == 1) return v;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int first = warp - warp % WPR;
  float s = red[first];
#pragma unroll
  for (int w = 1; w < WPR; ++w) s += red[first + w];
  __syncthreads();  // red is written again by the next reduction
  return s;
}

template <int VPT, int WPR>
__global__ void __launch_bounds__(kThreads, 4)
    layernorm_mod_kernel(const bf16* __restrict__ x, const float* __restrict__ mul,
                         const float* __restrict__ add, bf16* __restrict__ out, int n_rows, int S,
                         long long x_bstride, long long m_bstride, long long a_bstride, int d, float eps) {
  __shared__ float red[kWarps];
  constexpr int kRows = kWarps / WPR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = (warp % WPR) * 32 + lane;  // this thread's place in its row
  const int row = blockIdx.x * kRows + warp / WPR;
  const bool live = row < n_rows;
  const int nvec = d >> 3;
  const int b = live ? row / S : 0;
  const int s = live ? row - b * S : 0;
  const bf16* xr = x + (long long)b * x_bstride + (long long)s * d;

  uint4 raw[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = t + k * 32 * WPR;
    raw[k] = make_uint4(0u, 0u, 0u, 0u);
    if (live && v < nvec) raw[k] = __ldcs(reinterpret_cast<const uint4*>(xr) + v);
  }

  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (live && t + k * 32 * WPR < nvec) {
      float f[8];
      unpack8(raw[k], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, f[j]);
    }
  }
  const float inv_d = 1.0f / (float)d;
  const float mu = __fmul_rn(row_sum<WPR>(acc, red, warp, lane), inv_d);

  acc = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (live && t + k * 32 * WPR < nvec) {
      float f[8];
      unpack8(raw[k], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float dl = __fsub_rn(f[j], mu);
        acc = __fadd_rn(acc, __fmul_rn(dl, dl));
      }
    }
  }
  const float var = __fmul_rn(row_sum<WPR>(acc, red, warp, lane), inv_d);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  if (!live) return;

  const float4* mr = reinterpret_cast<const float4*>(mul + (long long)b * m_bstride);
  const float4* ar = reinterpret_cast<const float4*>(add + (long long)b * a_bstride);
  uint4* orow = reinterpret_cast<uint4*>(out + (long long)row * d);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = t + k * 32 * WPR;
    if (v < nvec) {
      float f[8];
      unpack8(raw[k], f);
      const float4 m0 = __ldg(mr + 2 * v), m1 = __ldg(mr + 2 * v + 1);
      const float4 a0 = __ldg(ar + 2 * v), a1 = __ldg(ar + 2 * v + 1);
      const float ms[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
      const float as[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      uint4 o;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[2 * j], mu), rstd), ms[2 * j]), as[2 * j]);
        const float y1 =
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[2 * j + 1], mu), rstd), ms[2 * j + 1]), as[2 * j + 1]);
        oh[j] = __floats2bfloat162_rn(y0, y1);
      }
      orow[v] = o;
    }
  }
}

template <int VPT, int WPR>
int launch(const void* x, const void* mul, const void* add, void* out, int n_rows, int S, long long x_bstride,
           long long m_bstride, long long a_bstride, int d, float eps, cudaStream_t stream) {
  constexpr int kRows = kWarps / WPR;
  const unsigned grid = (unsigned)((n_rows + kRows - 1) / kRows);
  layernorm_mod_kernel<VPT, WPR><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(mul), static_cast<const float*>(add),
      static_cast<bf16*>(out), n_rows, S, x_bstride, m_bstride, a_bstride, d, eps);
  return (int)cudaGetLastError();
}

template <int WPR>
int launch_wpr(int vpt, const void* x, const void* mul, const void* add, void* out, int n_rows, int S,
               long long x_bstride, long long m_bstride, long long a_bstride, int d, float eps,
               cudaStream_t stream) {
#define SVT_LNM_CASE(V) \
  case V:               \
    return launch<V, WPR>(x, mul, add, out, n_rows, S, x_bstride, m_bstride, a_bstride, d, eps, stream);
  switch (vpt) {
    SVT_LNM_CASE(1)
    SVT_LNM_CASE(2)
    SVT_LNM_CASE(3)
    SVT_LNM_CASE(4)
  }
#undef SVT_LNM_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (B, S, d) bf16, rows of d contiguous, batch stride x_bstride elements;
// mul/add f32 (B, d) with batch strides m_bstride / a_bstride (0: one (d,)
// vector); out (B, S, d) bf16 contiguous. d % 8 == 0, d <= 8192, 16-byte
// aligned rows and vectors (checked by the wrapper in ops/layernorm_mod.py;
// anything else returns cudaErrorInvalidValue).
extern "C" int svt_layernorm_mod(const void* x, const void* mul, const void* add, void* out, int B, int S,
                                 long long x_bstride, long long m_bstride, long long a_bstride, int d, float eps,
                                 void* stream) {
  const int nvec = d / 8;
  if (d <= 0 || d % 8 || nvec > kMaxVpt * 32 * kWarps) return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)B * S;
  if (n_rows == 0) return 0;
  if (n_rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int wpr = 1;
  while (nvec > kMaxVpt * 32 * wpr) wpr *= 2;
  const int vpt = (nvec + 32 * wpr - 1) / (32 * wpr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wpr) {
    case 1:
      return launch_wpr<1>(vpt, x, mul, add, out, (int)n_rows, S, x_bstride, m_bstride, a_bstride, d, eps, st);
    case 2:
      return launch_wpr<2>(vpt, x, mul, add, out, (int)n_rows, S, x_bstride, m_bstride, a_bstride, d, eps, st);
    case 4:
      return launch_wpr<4>(vpt, x, mul, add, out, (int)n_rows, S, x_bstride, m_bstride, a_bstride, d, eps, st);
    case 8:
      return launch_wpr<8>(vpt, x, mul, add, out, (int)n_rows, S, x_bstride, m_bstride, a_bstride, d, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}
