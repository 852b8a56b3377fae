// q/k RMSNorm + interleaved RoPE, bf16 in and out, f32 math, sm_90a, written
// straight into the attention's head layout:
//   n       = bf16( x * rsqrt(mean(x^2 over the group) + eps) )     (f32)
//   y       = bf16( n * bf16(w) )
//   out[2i] = bf16( y[2i] cos_i - y[2i+1] sin_i ), out[2i+1] = bf16( y[2i] sin_i + y[2i+1] cos_i )
// for tokens s < n_rope (the table's rows); the tokens after them are written
// as y, unrotated. out is (B, H, S_out, D) contiguous and token s of x lands
// in row r0 + s.
//
// Replaces no TPU kernel on its own: the JAX package leaves the q/k norm to
// XLA and rotates with ops/rope_pallas.py (K2, csrc/rope.cu here). On the
// card the port ran the norm as ~8 eager passes over f32 temporaries, a
// transpose copy to the heads' layout and K2 (PERF.md §5). The Wan and
// HunyuanVideo blocks call it at every `model.qk` site through
// ops/qk_norm_rope.py.
//
// The norm group is the weight's length G: the whole token (G = d, Wan's
// WanRMSNorm over the hidden dim) or one head (G = D, HunyuanVideo's
// per-head q/k norm). The same kernel runs both: only the reduction's width
// differs.
//
// What bounds it on the H100: device-memory bandwidth, one bf16 read of x
// and one bf16 write (4 bytes an element; the weight is a row, the (n_rope,
// D/2) f32 tables a row a token, read from L1/L2 across the token's heads).
// Design, as csrc/layernorm_mod.cu: whole tokens in registers as packed
// bf16, one 16-byte load per 8 elements, WPR warps a token (the fewest of 1,
// 2, 4, 8 that hold it in VPT <= 6 loads a thread: at most 64 registers, so
// 4 CTAs of 256 threads an SM; Wan 1.3B's d = 1536 one warp, HunyuanVideo's
// 3072 two, Wan 14B's 5120 four), 8 / WPR tokens a CTA. Up to 6 loads a
// thread ran 3-11% faster than up to 4 at those widths, and the weight
// product as packed bf16x2 (one conversion a pair, the same rounding) 3-4%
// faster than value by value (PERF.md §6). Thread t of a token holds vectors
// t + 32 WPR k, so the D / 8 vectors of one head sit in D / 8 consecutive
// lanes of one warp for every k: a head's sum of squares is a butterfly over
// those lanes, a token's a butterfly over the warp plus a fixed-order sum of
// the token's warps in shared memory. Every thread of a group gets the same
// bits. Products and sums round separately (__fmul_rn / __fadd_rn /
// __fsub_rn, no FMA contraction), in the eager expression's order; the sum
// of squares runs in another order than PyTorch's, so the normalised value
// may round to the neighbouring bf16 (one ulp, carried through the weight
// and the rotation). x is addressed as (B, S, d) with a batch and a token
// stride and rows of d contiguous, so a column slice of a fused qkv
// projection needs no copy. Each head's D outputs of a token are one
// contiguous store of 2 D bytes (16 lanes x 16 bytes at D = 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVpt = 6;

// The 8 f32 values of 8 packed bf16. The empty asm hides the words' value
// from the compiler, so each pass unpacks them anew and a vector holds 4
// registers between the passes, not 8.
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

// The sum of x^2 over one vector's 8 values, 0 for a vector past the row.
__device__ __forceinline__ float sum_sq8(uint4 raw, bool on) {
  float acc = 0.f;
  if (on) {
    float f[8];
    unpack8(raw, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, __fmul_rn(f[j], f[j]));
  }
  return acc;
}

// The sum of v over the WPR warps of this thread's token, the same bits in
// every thread of the token. Every thread of the CTA calls it (it may sync).
template <int WPR>
__device__ __forceinline__ float token_sum(float v, float* red, int warp, int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (WPR == 1) return v;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int first = warp - warp % WPR;
  float s = red[first];
#pragma unroll
  for (int w = 1; w < WPR; ++w) s += red[first + w];
  __syncthreads();
  return s;
}

// The sum of v over the `lanes` consecutive lanes of one head (a power of
// two dividing 32). Every lane of the warp calls it.
__device__ __forceinline__ float head_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int VPT, int WPR, bool HEAD>
__global__ void __launch_bounds__(kThreads, 4)
    qk_norm_rope_kernel(const bf16* __restrict__ x, const float* __restrict__ w, const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t, bf16* __restrict__ out, int n_rows, int S,
                        long long x_bstride, long long x_sstride, int d, int D, int H, int n_rope, int S_out, int r0,
                        float eps) {
  __shared__ float red[kWarps];
  constexpr int kRows = kWarps / WPR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = (warp % WPR) * 32 + lane;  // this thread's place in its token
  const int row = blockIdx.x * kRows + warp / WPR;
  const bool live = row < n_rows;
  const int nvec = d >> 3;
  const int b = live ? row / S : 0;
  const int s = live ? row - b * S : 0;
  const bf16* xr = x + (long long)b * x_bstride + (long long)s * x_sstride;

  uint4 raw[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = t + k * 32 * WPR;
    raw[k] = make_uint4(0u, 0u, 0u, 0u);
    if (live && v < nvec) raw[k] = __ldcs(reinterpret_cast<const uint4*>(xr) + v);
  }

  // rstd[k]: the rsqrt of vector k's group's mean square (one value for
  // every k when the group is the token)
  float rstd[VPT];
  if (HEAD) {
    const int lanes = D >> 3;
    const float inv_g = 1.0f / (float)D;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const float ss = head_sum(sum_sq8(raw[k], live && t + k * 32 * WPR < nvec), lanes);
      rstd[k] = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_g), eps));
    }
  } else {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) acc = __fadd_rn(acc, sum_sq8(raw[k], live && t + k * 32 * WPR < nvec));
    const float ss = token_sum<WPR>(acc, red, warp, lane);
    const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / (float)d), eps));
#pragma unroll
    for (int k = 0; k < VPT; ++k) rstd[k] = r;
  }
  if (!live) return;

  const bool rotate = s < n_rope;
  const int half = D >> 1;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = t + k * 32 * WPR;
    if (v < nvec) {
      const int e = v * 8;
      const int hh = e / D;
      const int dh = e - hh * D;
      const float4* wr = reinterpret_cast<const float4*>(w + (HEAD ? dh : e));
      const float4 w0 = __ldg(wr), w1 = __ldg(wr + 1);
      const float ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      float f[8];
      unpack8(raw[k], f);
      // y = bf16(bf16(x rstd) bf16(w)): the product of two bf16 is exact in
      // f32, so __hmul2's one rounding is the eager product's
      float y[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 n2 = __floats2bfloat162_rn(__fmul_rn(f[2 * j], rstd[k]), __fmul_rn(f[2 * j + 1], rstd[k]));
        const float2 y2 = __bfloat1622float2(__hmul2(n2, __floats2bfloat162_rn(ws[2 * j], ws[2 * j + 1])));
        y[2 * j] = y2.x;
        y[2 * j + 1] = y2.y;
      }
      uint4 o;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
      if (rotate) {
        const float4 c = __ldg(reinterpret_cast<const float4*>(cos_t + (long long)s * half + (dh >> 1)));
        const float4 sn = __ldg(reinterpret_cast<const float4*>(sin_t + (long long)s * half + (dh >> 1)));
        const float cs[4] = {c.x, c.y, c.z, c.w};
        const float ss[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x0 = y[2 * j], x1 = y[2 * j + 1];
          oh[j] = __floats2bfloat162_rn(__fsub_rn(__fmul_rn(x0, cs[j]), __fmul_rn(x1, ss[j])),
                                        __fadd_rn(__fmul_rn(x0, ss[j]), __fmul_rn(x1, cs[j])));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) oh[j] = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
      }
      bf16* orow = out + ((long long)(b * H + hh) * S_out + r0 + s) * D + dh;
      *reinterpret_cast<uint4*>(orow) = o;
    }
  }
}

template <int VPT, int WPR, bool HEAD>
int launch(const void* x, const void* w, const void* cos_t, const void* sin_t, void* out, int n_rows, int S,
           long long x_bstride, long long x_sstride, int d, int D, int H, int n_rope, int S_out, int r0, float eps,
           cudaStream_t stream) {
  constexpr int kRows = kWarps / WPR;
  const unsigned grid = (unsigned)((n_rows + kRows - 1) / kRows);
  qk_norm_rope_kernel<VPT, WPR, HEAD><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(out), n_rows, S, x_bstride, x_sstride, d, D, H, n_rope,
      S_out, r0, eps);
  return (int)cudaGetLastError();
}

template <int WPR, bool HEAD>
int launch_vpt(int vpt, const void* x, const void* w, const void* cos_t, const void* sin_t, void* out, int n_rows,
               int S, long long x_bstride, long long x_sstride, int d, int D, int H, int n_rope, int S_out, int r0,
               float eps, cudaStream_t stream) {
#define SVT_QKN_CASE(V)                                                                                         \
  case V:                                                                                                      \
    return launch<V, WPR, HEAD>(x, w, cos_t, sin_t, out, n_rows, S, x_bstride, x_sstride, d, D, H, n_rope, S_out, \
                                r0, eps, stream);
  switch (vpt) {
    SVT_QKN_CASE(1)
    SVT_QKN_CASE(2)
    SVT_QKN_CASE(3)
    SVT_QKN_CASE(4)
    SVT_QKN_CASE(5)
    SVT_QKN_CASE(6)
  }
#undef SVT_QKN_CASE
  return (int)cudaErrorInvalidValue;
}

template <bool HEAD>
int launch_wpr(int wpr, int vpt, const void* x, const void* w, const void* cos_t, const void* sin_t, void* out,
               int n_rows, int S, long long x_bstride, long long x_sstride, int d, int D, int H, int n_rope, int S_out,
               int r0, float eps, cudaStream_t stream) {
#define SVT_QKN_WPR(P)                                                                                               \
  case P:                                                                                                            \
    return launch_vpt<P, HEAD>(vpt, x, w, cos_t, sin_t, out, n_rows, S, x_bstride, x_sstride, d, D, H, n_rope, S_out, \
                               r0, eps, stream);
  switch (wpr) {
    SVT_QKN_WPR(1)
    SVT_QKN_WPR(2)
    SVT_QKN_WPR(4)
    SVT_QKN_WPR(8)
  }
#undef SVT_QKN_WPR
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (B, S, d) bf16, rows of d contiguous, batch and token strides in
// elements (multiples of 8); w f32 (G,) with G = d (the token) or G = d / H
// (a head); cos/sin f32 (n_rope, D/2) contiguous, n_rope <= S (null when
// n_rope is 0); out (B, H, S_out, D) bf16 contiguous, token s written to row
// r0 + s, r0 + S <= S_out. d % 8 == 0, d <= 8192, D = d / H with D % 8 == 0,
// and for G = D, 32 % (D / 8) == 0; 16-byte aligned rows, weight and tables
// (checked by the wrapper in ops/qk_norm_rope.py; anything else returns
// cudaErrorInvalidValue).
extern "C" int svt_qk_norm_rope(const void* x, const void* w, const void* cos_t, const void* sin_t, void* out, int B,
                                int S, long long x_bstride, long long x_sstride, int d, int G, int H, int n_rope,
                                int S_out, int r0, float eps, void* stream) {
  const int nvec = d / 8;
  if (d <= 0 || d % 8 || nvec > kMaxVpt * 32 * kWarps || H <= 0 || d % H) return (int)cudaErrorInvalidValue;
  const int D = d / H;
  const bool head = G != d;
  if (D % 8 || (head && (G != D || 32 % (D / 8)))) return (int)cudaErrorInvalidValue;
  if (n_rope < 0 || n_rope > S || (n_rope > 0 && (cos_t == nullptr || sin_t == nullptr)) || r0 < 0 ||
      (long long)r0 + S > S_out)
    return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)B * S;
  if (n_rows == 0) return 0;
  if (n_rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int wpr = 1;
  while (nvec > kMaxVpt * 32 * wpr) wpr *= 2;
  const int vpt = (nvec + 32 * wpr - 1) / (32 * wpr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head)
    return launch_wpr<true>(wpr, vpt, x, w, cos_t, sin_t, out, (int)n_rows, S, x_bstride, x_sstride, d, D, H, n_rope,
                            S_out, r0, eps, st);
  return launch_wpr<false>(wpr, vpt, x, w, cos_t, sin_t, out, (int)n_rows, S, x_bstride, x_sstride, d, D, H, n_rope,
                           S_out, r0, eps, st);
}
