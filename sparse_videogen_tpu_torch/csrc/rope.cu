// Interleaved 3-D RoPE, bf16 in and out, f32 math, sm_90a.
//
// Replaces the TPU kernel sparse_videogen_tpu/ops/rope_pallas.py::_rope_kernel
// (entries _rope_direct and rope_apply_pallas):
//   out[2i]   = x[2i] * cos_i - x[2i+1] * sin_i
//   out[2i+1] = x[2i] * sin_i + x[2i+1] * cos_i
// computed in f32 and rounded to bf16. The TPU kernel needed lane tables
// (expand_cos_sin) and lane rolls because its vector unit cannot
// de-interleave pairs cheaply; here a thread simply holds whole pairs, so the
// kernel reads the (S, D/2) f32 cos/sin tables directly.
//
// What bounds it on the H100: device-memory bandwidth (2 bytes in + 2 bytes
// out per element, plus the tables, which stay in L2 across heads). Design:
// one thread per 8 elements (one 16-byte load of x, two 16-byte loads of the
// tables, one 16-byte store), a grid-stride loop over the flat (BH*S*D)
// array. Products and sums round separately (__fmul_rn / __fadd_rn) so the
// result equals PyTorch's elementwise f32 evaluation bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__global__ void rope_kernel(const bf16* __restrict__ x, const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t, bf16* __restrict__ out, int S, int D,
                            size_t n_vec) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i * 8;
    const int d = (int)(e % D);
    const size_t s = (e / D) % S;
    uint4 raw = *reinterpret_cast<const uint4*>(x + e);
    const float4 c = *reinterpret_cast<const float4*>(cos_t + s * (D / 2) + d / 2);
    const float4 sn = *reinterpret_cast<const float4*>(sin_t + s * (D / 2) + d / 2);
    const float cs[4] = {c.x, c.y, c.z, c.w};
    const float ss[4] = {sn.x, sn.y, sn.z, sn.w};
    bf16* el = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = __bfloat162float(el[2 * j]);
      const float x1 = __bfloat162float(el[2 * j + 1]);
      const float o0 = __fsub_rn(__fmul_rn(x0, cs[j]), __fmul_rn(x1, ss[j]));
      const float o1 = __fadd_rn(__fmul_rn(x0, ss[j]), __fmul_rn(x1, cs[j]));
      el[2 * j] = __float2bfloat16_rn(o0);
      el[2 * j + 1] = __float2bfloat16_rn(o1);
    }
    *reinterpret_cast<uint4*>(out + e) = raw;
  }
}

}  // namespace

// x/out (BH, S, D) bf16 contiguous, cos/sin (S, D/2) f32 contiguous,
// D % 8 == 0 (checked by the wrapper in ops/rope.py).
extern "C" int svt_rope(const void* x, const void* cos_t, const void* sin_t, void* out, int BH, int S,
                        int D, void* stream) {
  const size_t n_vec = (size_t)BH * S * D / 8;
  if (n_vec == 0) return 0;
  const int threads = 256;
  size_t blocks = (n_vec + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  rope_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<bf16*>(out), S, D, n_vec);
  return (int)cudaGetLastError();
}
