// Block-sparse flash attention over chunked-CSR metadata, bf16, sm_90a.
//
// Replaces the TPU kernel sparse_videogen_tpu/ops/attention.py::_kernel
// (entry block_sparse_attention_kv). Same metadata (ops/metadata.py), same
// MaskSpec semantics (kinds "none" and "band_sink", global positions offset
// by aux[2]/aux[3]), same numerics: q is pre-scaled by scale*log2(e) and
// rounded to the input dtype, the online softmax runs in f32 in the exp2
// domain, P is rounded to bf16 for the PV product while the row sum uses the
// f32 P, and a row that sees no live column writes 0.
//
// Metadata row r = (R == 1 ? 0 : bh), q-block i = (tile * TQ) / block_q:
//   meta[r, i, 0]       = n_cheap * 4096 + n
//   meta[r, i, 1 + 2c]  = idx  (chunk start in 128-token sub-blocks)
//   meta[r, i, 2 + 2c]  = lo * 2048 + hi  (live columns [lo, hi) of the chunk)
// The first n_cheap chunks are proven fully allowed by the mask and only
// apply the window; the rest also evaluate the token-level predicate.
//
// What bounds it on the H100: the tensor-core FLOPs of QK^T and PV (4*S*S*D
// per head at density 1). Design: one CTA of 4 warps owns TQ = 64 q rows
// (16 per warp) for a (batch*head, q tile) pair; it walks the row's chunks
// in TK = 64-token sub-tiles, skipping sub-tiles outside [lo, hi), stages K
// and V sub-tiles in shared memory and runs both products on bf16 tensor
// cores with mma.sync m16n8k16 (f32 accumulate); the softmax state and the
// output accumulator stay in registers, and P goes from the QK^T
// accumulators straight into the PV A-fragments without touching memory.
// Loads are synchronous (no cp.async/TMA pipeline yet) and the products use
// mma.sync, not wgmma: this is the simple, correct first version; several
// resident CTAs per SM hide part of the load latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TQ = 64;
constexpr int TK = 64;
constexpr int NTHREADS = 128;
constexpr int SUB = 128;
constexpr int ENTRY_SCALE = 2048;
constexpr int N_CHEAP_SCALE = 4096;
constexpr float NEG_INF = -0.7f * 3.402823466e38f;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> packed bf16x2, `lo` in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_b2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bsa_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           bf16* __restrict__ o, const int* __restrict__ meta, const int* __restrict__ aux,
           int Sq, int Skv, int R, int nQ, int L, int block_q, int mask_kind, int band_width,
           int sink_size, float q_scale) {
  constexpr int LD = D + 8;  // padded smem row (bf16): conflict-free fragment reads
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + TQ * LD;
  bf16* sV = sK + TK * LD;

  const int tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread in group
  const int q0 = tile * TQ;

  const bf16* qb = q + ((size_t)bh * Sq + q0) * D;
  const bf16* kb = k + (size_t)bh * Skv * D;
  const bf16* vb = v + (size_t)bh * Skv * D;

  // Q tile, pre-scaled and rounded to bf16 exactly like the TPU kernel
  for (int c = threadIdx.x; c < TQ * VPR; c += NTHREADS) {
    const int r = c / VPR, col = (c % VPR) * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(qb + (size_t)r * D + col);
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * q_scale);
    *reinterpret_cast<uint4*>(sQ + r * LD + col) = raw;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p = sQ + r0 * LD + kk * 16 + 2 * t4;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }

  const int row = (R == 1) ? 0 : bh;
  const int* m = meta + ((size_t)row * nQ + q0 / block_q) * L;
  const int e0 = m[0];
  const int n = e0 % N_CHEAP_SCALE;
  const int n_cheap = e0 / N_CHEAP_SCALE;
  const int qpos[2] = {q0 + r0 + aux[2], q0 + r0 + 8 + aux[2]};
  const int koff = aux[3];

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};

  for (int c = 0; c < n; ++c) {
    const int idx = m[1 + 2 * c];
    const int win = m[2 + 2 * c];
    const int lo = win / ENTRY_SCALE;
    const int hi = win % ENTRY_SCALE;
    const bool pred = mask_kind != 0 && c >= n_cheap;
    const int base = idx * SUB;
    for (int s0 = (lo / TK) * TK; s0 < hi; s0 += TK) {
      __syncthreads();  // every warp is done with the previous K/V sub-tile
      for (int cc = threadIdx.x; cc < TK * VPR; cc += NTHREADS) {
        const int r = cc / VPR, col = (cc % VPR) * 8;
        const int tok = base + s0 + r;
        uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
        if (tok < Skv) {
          kr = *reinterpret_cast<const uint4*>(kb + (size_t)tok * D + col);
          vr = *reinterpret_cast<const uint4*>(vb + (size_t)tok * D + col);
        }
        *reinterpret_cast<uint4*>(sK + r * LD + col) = kr;
        *reinterpret_cast<uint4*>(sV + r * LD + col) = vr;
      }
      __syncthreads();

      // S = Q K^T for this warp's 16 rows x TK columns
      float s[TK / 8][4];
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const bf16* p = sK + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
          mma_16816(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(p),
                    *reinterpret_cast<const uint32_t*>(p + 8));
        }
      }

      // window on every chunk; band_sink predicate on the non-cheap ones
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = s0 + nt * 8 + 2 * t4 + (j & 1);
          bool ok = col >= lo && col < hi;
          if (pred && ok) {
            const int kp = base + col + koff;
            const int d = qpos[j >> 1] - kp;
            ok = (d < band_width && d > -band_width) || kp < sink_size;
          }
          if (!ok) s[nt][j] = NEG_INF;
        }
      }

      // online softmax, exp2 domain; each row lives in the 4 threads of a quad
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = NEG_INF;
#pragma unroll
        for (int nt = 0; nt < TK / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * rr], s[nt][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[rr], mx);
        const float alpha = exp2f(m_i[rr] - m_new);
        // a row with no live column so far exponentiates against 0: p == 0
        const float m_safe = m_new > 0.5f * NEG_INF ? m_new : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < TK / 8; ++nt) {
          s[nt][2 * rr] = exp2f(s[nt][2 * rr] - m_safe);
          s[nt][2 * rr + 1] = exp2f(s[nt][2 * rr + 1] - m_safe);
          sum += s[nt][2 * rr] + s[nt][2 * rr + 1];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_i[rr] = l_i[rr] * alpha + sum;
        m_i[rr] = m_new;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          acc[dt][2 * rr] *= alpha;
          acc[dt][2 * rr + 1] *= alpha;
        }
      }

      // O += P V: the S accumulators of two n-tiles form one A fragment
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_f2(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_f2(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_f2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_f2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          const bf16* p = sV + (kk * 16 + 2 * t4) * LD + dt * 8 + g;
          mma_16816(acc[dt], a, pack_b2(p[0], p[LD]), pack_b2(p[8 * LD], p[9 * LD]));
        }
      }
    }
  }

  // rows that never saw a live column have acc == 0 and l == 0 -> 0
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float inv = 1.f / fmaxf(l_i[rr], 1e-20f);
    bf16* orow = o + ((size_t)bh * Sq + q0 + r0 + 8 * rr) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[dt][2 * rr] * inv, acc[dt][2 * rr + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* meta, const int* aux,
                   int BH, int Sq, int Skv, int R, int nQ, int L, int block_q, int mask_kind,
                   int band_width, int sink_size, float q_scale, cudaStream_t stream) {
  const int smem = (TQ + 2 * TK) * (D + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(bsa_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / TQ, BH);
  bsa_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), meta, aux, Sq, Skv, R, nQ, L, block_q, mask_kind, band_width, sink_size,
      q_scale);
  return cudaGetLastError();
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/attention.py): q (BH, Sq, D),
// k/v (BH, Skv, D), o (BH, Sq, D), all bf16 contiguous; meta (R, nQ, L)
// int32; aux (4,) int32 on the device; Sq % block_q == 0, block_q % 64 == 0.
extern "C" int svt_block_sparse_attn(const void* q, const void* k, const void* v, void* o,
                                     const void* meta, const void* aux, int BH, int Sq, int Skv, int D,
                                     int R, int nQ, int L, int block_q, int mask_kind, int band_width,
                                     int sink_size, float q_scale, void* stream) {
  // chunk extents come from the [lo, hi) windows, so block_kv is not needed
  const int* m = static_cast<const int*>(meta);
  const int* a = static_cast<const int*>(aux);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch<128>(q, k, v, o, m, a, BH, Sq, Skv, R, nQ, L, block_q, mask_kind, band_width,
                            sink_size, q_scale, s);
  if (D == 64)
    return (int)launch<64>(q, k, v, o, m, a, BH, Sq, Skv, R, nQ, L, block_q, mask_kind, band_width,
                           sink_size, q_scale, s);
  return (int)cudaErrorInvalidValue;
}
