// Dense flash attention with q-split sub-tiles, bf16, sm_90a (K7).
//
// Replaces the TPU kernel scripts/bench_qsplit.py::_kernel (entry dense_attn),
// a probe of whether independent q sub-tiles, each with its own online-softmax
// state, overlap one sub-tile's softmax with another's products. Its numerics:
// q pre-scaled by D^-1/2 in f32 and rounded to bf16; natural-exp online
// softmax in f32 (evaluated as exp2((s - m) * log2 e)); P rounded to bf16 for
// PV while the row sum uses the f32 P; out = acc / max(l, 1e-20). Separate K
// and V: the TPU's packed [K|V] rows and its nbuf DMA semaphores are TPU
// choices.
//
// What bounds it on the H100: the tensor-core FLOPs, 4 * S * S * D per head.
// Design (the TPU kernel's idea, not its blocks): one CTA owns BQ = 16 * NW *
// QS q rows as QS independent sub-tiles of SQ = 16 * NW rows; warp w holds 16
// rows of every sub-tile, each with its own (acc, m, l) in registers, so a
// warp carries QS independent dependency chains. The K/V sequence is walked
// in TK = 64-token sub-tiles staged in shared memory by cp.async, double
// buffered (the next sub-tile loads while this one is used), and every
// sub-tile of every warp reads the same staged K/V: a larger BQ shares each
// K/V load across more q rows than K1's 64-row CTA. The q tile stays in
// shared memory and each sub-tile's A-fragments are re-read from it, one at a
// time, per K/V sub-tile (registers hold the QS accumulators). The TPU's bkv
// (its DMA chunk) has no role here beyond S % bkv == 0: the online softmax
// rescales per 64-token sub-tile. The f32 accumulators bound BQ: 128 floats a row, so 256
// rows take half of an SM's register file; the compiled (BQ, QS) pairs are
// (64, 1), (128, 1), (128, 2), (256, 1), (256, 2) (ops/dense_qsplit.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TK = 64;  // K/V tokens a sub-tile
constexpr float NEG_INF = -0.7f * 3.402823466e38f;
constexpr float LOG2E_F = 1.4426950408889634f;

// c (16 x 8, f32) += A (16 x 16, bf16 fragments) . B (16 x 8, bf16 fragments)
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D, int NW, int QS>
__global__ void __launch_bounds__(NW * 32, 1)
qsplit_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              bf16* __restrict__ o, int S, float q_scale) {
  constexpr int LD = D + 8;  // padded smem row (bf16): conflict-free fragment reads
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  constexpr int NT = NW * 32;
  constexpr int SQ = 16 * NW;  // rows of one sub-tile
  constexpr int BQ = SQ * QS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * LD;  // [2][TK][LD]
  bf16* sV = sK + 2 * TK * LD;  // [2][TK][LD]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bf16* kb = k + (size_t)bh * S * D;
  const bf16* vb = v + (size_t)bh * S * D;

  auto stage = [&](int j, int buf) {
    bf16* dk = sK + buf * TK * LD;
    bf16* dv = sV + buf * TK * LD;
    const size_t tok0 = (size_t)j * TK;
    for (int c = threadIdx.x; c < TK * VPR; c += NT) {
      const int r = c / VPR, col = (c % VPR) * 8;
      cp_async16(dk + r * LD + col, kb + (tok0 + r) * D + col);
      cp_async16(dv + r * LD + col, vb + (tok0 + r) * D + col);
    }
  };
  stage(0, 0);
  cp_async_commit();

  // the q tile, scaled in f32 and rounded to bf16 (the TPU kernel's q_s)
  const bf16* qb = q + ((size_t)bh * S + q0) * D;
  for (int c = threadIdx.x; c < BQ * VPR; c += NT) {
    const int r = c / VPR, col = (c % VPR) * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(qb + (size_t)r * D + col);
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * q_scale);
    *reinterpret_cast<uint4*>(sQ + r * LD + col) = raw;
  }

  float acc[QS][D / 8][4];
  float m_i[QS][2], l_i[QS][2];
#pragma unroll
  for (int t = 0; t < QS; ++t) {
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) acc[t][dt][0] = acc[t][dt][1] = acc[t][dt][2] = acc[t][dt][3] = 0.f;
    m_i[t][0] = m_i[t][1] = NEG_INF;
    l_i[t][0] = l_i[t][1] = 0.f;
  }

  const int nsub = S / TK;
  for (int j = 0; j < nsub; ++j) {
    if (j + 1 < nsub) {
      stage(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // sub-tile j (and, at j == 0, the q tile) visible to every warp
    const bf16* cK = sK + (j & 1) * TK * LD;
    const bf16* cV = sV + (j & 1) * TK * LD;
#pragma unroll
    for (int t = 0; t < QS; ++t) {
      // S = Q K^T for this warp's 16 rows of sub-tile t; one q A-fragment
      // (4 registers) at a time, read from the shared q tile
      float s[TK / 8][4];
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* q_rows = sQ + (t * SQ + warp * 16 + g) * LD + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* pq = q_rows + kk * 16;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(pq), *reinterpret_cast<const uint32_t*>(pq + 8 * LD),
                               *reinterpret_cast<const uint32_t*>(pq + 8),
                               *reinterpret_cast<const uint32_t*>(pq + 8 * LD + 8)};
#pragma unroll
        for (int nt = 0; nt < TK / 8; ++nt) {
          const bf16* p = cK + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
          mma_16816(s[nt], a, *reinterpret_cast<const uint32_t*>(p), *reinterpret_cast<const uint32_t*>(p + 8));
        }
      }
      // online softmax, natural exp; each row lives in the 4 threads of a quad
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = NEG_INF;
#pragma unroll
        for (int nt = 0; nt < TK / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * rr], s[nt][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[t][rr], mx);
        const float alpha = exp2f((m_i[t][rr] - m_new) * LOG2E_F);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < TK / 8; ++nt) {
          s[nt][2 * rr] = exp2f((s[nt][2 * rr] - m_new) * LOG2E_F);
          s[nt][2 * rr + 1] = exp2f((s[nt][2 * rr + 1] - m_new) * LOG2E_F);
          sum += s[nt][2 * rr] + s[nt][2 * rr + 1];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_i[t][rr] = l_i[t][rr] * alpha + sum;
        m_i[t][rr] = m_new;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          acc[t][dt][2 * rr] *= alpha;
          acc[t][dt][2 * rr + 1] *= alpha;
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
          const bf16* p = cV + (kk * 16 + 2 * t4) * LD + dt * 8 + g;
          mma_16816(acc[t][dt], a, pack_b2(p[0], p[LD]), pack_b2(p[8 * LD], p[9 * LD]));
        }
      }
    }
    __syncthreads();  // every warp is done with sub-tile j before stage j + 2 overwrites it
  }

#pragma unroll
  for (int t = 0; t < QS; ++t) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float inv = 1.f / fmaxf(l_i[t][rr], 1e-20f);
      bf16* orow = o + ((size_t)bh * S + q0 + t * SQ + warp * 16 + g + 8 * rr) * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[t][dt][2 * rr] * inv, acc[t][dt][2 * rr + 1] * inv);
      }
    }
  }
}

template <int D, int NW, int QS>
cudaError_t launch_qsplit(const void* q, const void* k, const void* v, void* o, int BH, int S, float q_scale,
                          cudaStream_t stream) {
  constexpr int BQ = 16 * NW * QS;
  const int smem = (BQ + 4 * TK) * (D + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(qsplit_kernel<D, NW, QS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / BQ, BH);
  qsplit_kernel<D, NW, QS><<<grid, NW * 32, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                                             static_cast<const bf16*>(v), static_cast<bf16*>(o), S,
                                                             q_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int BH, int S, int bq, int qsplit,
                     float q_scale, cudaStream_t s) {
  if (qsplit == 1 && bq == 64) return launch_qsplit<D, 4, 1>(q, k, v, o, BH, S, q_scale, s);
  if (qsplit == 1 && bq == 128) return launch_qsplit<D, 8, 1>(q, k, v, o, BH, S, q_scale, s);
  if (qsplit == 1 && bq == 256) return launch_qsplit<D, 16, 1>(q, k, v, o, BH, S, q_scale, s);
  if (qsplit == 2 && bq == 128) return launch_qsplit<D, 4, 2>(q, k, v, o, BH, S, q_scale, s);
  if (qsplit == 2 && bq == 256) return launch_qsplit<D, 8, 2>(q, k, v, o, BH, S, q_scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/dense_qsplit.py): q, k, v, o
// (BH, S, D) bf16 contiguous; S % bq == 0 and S % 64 == 0; (bq, qsplit) one of
// the compiled pairs.
extern "C" int svt_dense_qsplit(const void* q, const void* k, const void* v, void* o, int BH, int S, int D, int bq,
                                int qsplit, float q_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)dispatch<128>(q, k, v, o, BH, S, bq, qsplit, q_scale, s);
  if (D == 64) return (int)dispatch<64>(q, k, v, o, BH, S, bq, qsplit, q_scale, s);
  return (int)cudaErrorInvalidValue;
}
