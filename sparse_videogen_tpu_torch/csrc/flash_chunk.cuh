// The per-chunk body of the run-list flash attention kernel, bf16, sm_90a.
//
// It serves csrc/runs_attn.cu (K3/K4: the chunk comes from a walk over token
// runs) alone; csrc/dense_qsplit.cu (K7) borrows its mma helpers. The
// chunked-CSR kernel K1 (csrc/block_sparse_attn.cu) has its own TMA/wgmma
// body and shares only the mask predicates (csrc/mask_pred.cuh). The kernel
// gives one CTA of 4 warps TQ = 64 q rows (16 per warp); the CTA loads its
// q tile once (load_q_frags), calls attend_chunk for every chunk it visits,
// and writes its rows (store_rows).
//
// Numerics (the TPU kernels' own): q is pre-scaled by scale*log2(e) and
// rounded to bf16; the online softmax runs in f32 in the exp2 domain; P is
// rounded to bf16 for the PV product while the row sum uses the f32 P; a row
// that sees no live column writes 0.
//
// attend_chunk walks the chunk's live window [lo, hi) (relative to the token
// `base`) in TK = 64-token sub-tiles, staging K and V in shared memory, and
// runs QK^T and PV on bf16 tensor cores with mma.sync m16n8k16 (f32
// accumulate). The softmax state and the output accumulator stay in
// registers; P goes from the QK^T accumulators straight into the PV
// A-fragments. Loads are synchronous (no cp.async/TMA pipeline yet).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mask_pred.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TQ = 64;
constexpr int TK = 64;
constexpr int NTHREADS = 128;
constexpr int SUB = 128;
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

// A-fragments of a 16-row x D tile at `p0` (row stride ld, in bf16) for
// mma m16n8k16: this thread's rows g and g + 8, columns 2*t4 (+8) per k-step
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&af)[D / 16][4], const bf16* p0, int ld, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p = p0 + g * ld + kk * 16 + 2 * t4;
    af[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    af[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
    af[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    af[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
  }
}

template <int D>
struct FlashRows {
  uint32_t qf[D / 16][4];  // this warp's 16 pre-scaled q rows as A-fragments
  float acc[D / 8][4];     // output accumulator, rows g and g + 8
  float m_i[2];            // running max (exp2 domain)
  float l_i[2];            // running sum of f32 P
};

// Load the CTA's TQ q rows (from qb, row stride D), scale and round them like
// the TPU kernel, and reset the softmax state. sQ holds TQ x (D + 8) bf16.
template <int D>
__device__ __forceinline__ void load_q_frags(FlashRows<D>& st, const bf16* qb, bf16* sQ, float q_scale, int warp,
                                             int g, int t4) {
  constexpr int LD = D + 8;  // padded smem row (bf16): conflict-free fragment reads
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int c = threadIdx.x; c < TQ * VPR; c += NTHREADS) {
    const int r = c / VPR, col = (c % VPR) * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(qb + (size_t)r * D + col);
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * q_scale);
    *reinterpret_cast<uint4*>(sQ + r * LD + col) = raw;
  }
  __syncthreads();
  load_a_frags<D>(st.qf, sQ + warp * 16 * LD, LD, g, t4);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) st.acc[dt][0] = st.acc[dt][1] = st.acc[dt][2] = st.acc[dt][3] = 0.f;
  st.m_i[0] = st.m_i[1] = NEG_INF;
  st.l_i[0] = st.l_i[1] = 0.f;
}

// Attend this warp's rows to the live columns [lo, hi) of the chunk whose
// first token is `base` (kb/vb: the (Skv, D) K and V of this head). With
// `pred`, a column must also pass the mask predicate at global positions
// (qpos[row], base + col + koff). Every thread of the CTA must call it with
// the same chunk: it synchronises the CTA around the shared K/V sub-tiles.
template <int D, int KIND = KIND_BAND_SINK>
__device__ __forceinline__ void attend_chunk(FlashRows<D>& st, const bf16* kb, const bf16* vb, bf16* sK, bf16* sV,
                                             int Skv, int base, int lo, int hi, bool pred, const int (&qpos)[2],
                                             int koff, const MaskArgs& mk, int g, int t4) {
  constexpr int LD = D + 8;
  constexpr int VPR = D / 8;
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
        mma_16816(s[nt], st.qf[kk], *reinterpret_cast<const uint32_t*>(p), *reinterpret_cast<const uint32_t*>(p + 8));
      }
    }

    // the window on every chunk; the mask predicate where asked
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = s0 + nt * 8 + 2 * t4 + (j & 1);
        bool ok = col >= lo && col < hi;
        if (pred && ok) ok = mask_allows<KIND>(mk, qpos[j >> 1], base + col + koff);
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
      const float m_new = fmaxf(st.m_i[rr], mx);
      const float alpha = exp2f(st.m_i[rr] - m_new);
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
      st.l_i[rr] = st.l_i[rr] * alpha + sum;
      st.m_i[rr] = m_new;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        st.acc[dt][2 * rr] *= alpha;
        st.acc[dt][2 * rr + 1] *= alpha;
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
        mma_16816(st.acc[dt], a, pack_b2(p[0], p[LD]), pack_b2(p[8 * LD], p[9 * LD]));
      }
    }
  }
}

// Normalise and write this thread's two rows (orow0: row g of the warp's 16,
// row stride D); rows that never saw a live column have acc == 0, l == 0 -> 0.
template <int D>
__device__ __forceinline__ void store_rows(const FlashRows<D>& st, bf16* orow0, int t4) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float inv = 1.f / fmaxf(st.l_i[rr], 1e-20f);
    bf16* orow = orow0 + (size_t)8 * rr * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(st.acc[dt][2 * rr] * inv, st.acc[dt][2 * rr + 1] * inv);
    }
  }
}

// dynamic shared memory of the run-list kernel: a q tile and one K and one
// V sub-tile, rows padded to D + 8
template <int D>
constexpr int flash_smem_bytes() {
  return (TQ + 2 * TK) * (D + 8) * (int)sizeof(bf16);
}

}  // namespace
