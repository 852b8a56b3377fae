// Block-sparse flash attention over chunked-CSR metadata, bf16, sm_90a (K1).
//
// Replaces the TPU kernel sparse_videogen_tpu/ops/attention.py::_kernel
// (entry block_sparse_attention_kv). Same metadata (ops/metadata.py), same
// MaskSpec semantics (kinds "none", "band_sink", "hyvideo" and "cog", global
// positions offset by aux[2]/aux[3], hyvideo's real length or cog's prompt
// length in aux[0]; csrc/mask_pred.cuh), same numerics: q pre-scaled by
// scale*log2(e) and rounded to bf16, the online softmax in f32 in the exp2
// domain, P rounded to bf16 for PV while the row sum uses the f32 P, 0 for a
// row that sees no live column.
//
// Metadata row r = (R == 1 ? 0 : bh), q-block i = (tile * BQ) / block_q:
//   meta[r, i, 0]       = n_cheap * 4096 + n
//   meta[r, i, 1 + 2c]  = idx  (chunk start in 128-token sub-blocks)
//   meta[r, i, 2 + 2c]  = lo * 2048 + hi  (live columns [lo, hi) of the chunk)
// The first n_cheap chunks are proven fully allowed by the mask and only
// apply the window; the rest also evaluate the token-level predicate.
//
// The CTA body (TMA ring, wgmma, two consumer warpgroups of 64 q rows,
// tile-level mask classification, heaviest items first) is
// csrc/hopper_attn.cuh, shared with the run-list kernel K3/K4; this file
// gives it the chunked-CSR chunk source and the C entry.

#include "hopper_attn.cuh"

namespace {

constexpr int ENTRY_SCALE = 2048;
constexpr int N_CHEAP_SCALE = 4096;

// chunk c of a metadata row: s0 = idx_c * 128, [lo, hi) from win_c; the
// first n_cheap chunks skip the predicate, and kind none (mask_kind 0)
// never evaluates it
struct CsrChunks {
  const int* m;  // the row: (n + n_cheap * N_CHEAP_SCALE, idx_0, win_0, idx_1, ...)
  int n, n_cheap, mask_kind;

  template <class F>
  __device__ __forceinline__ void walk(F&& f) const {
    for (int c = 0; c < n; ++c) {
      const int win = m[2 + 2 * c];
      f(m[1 + 2 * c] * SUB, win / ENTRY_SCALE, win % ENTRY_SCALE, !(mask_kind == 0 || c < n_cheap));
    }
  }
};

template <int D, int KIND>
__global__ void __launch_bounds__(NTHREADS, 1)
bsa_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, const int* __restrict__ meta,
           const int* __restrict__ aux, const int* __restrict__ order, int Sq, int Skv, int R, int nQ, int L,
           int block_q, int mask_kind, int band_width, int sink_size, int video_len, float q_scale) {
  const WorkItem it = work_item(order, Sq);
  const int* m = meta + ((size_t)(R == 1 ? 0 : it.bh) * nQ + it.q0 / block_q) * L;
  const CsrChunks chunks = {m, m[0] % N_CHEAP_SCALE, m[0] / N_CHEAP_SCALE, mask_kind};
  attn_cta<D, KIND>(&tm_q, &tm_k, &tm_v, o, chunks, it, Sq, Skv, aux, band_width, sink_size, video_len, q_scale);
}

template <int D, int KIND>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* meta, const int* aux,
                   const int* order, int BH, int Sq, int Skv, int R, int nQ, int L, int block_q, int mask_kind,
                   int band_width, int sink_size, int video_len, float q_scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_qkv_maps(&tq, &tk, &tv, q, k, v, BH, Sq, Skv, D)) return cudaErrorInvalidValue;
  const int smem = Layout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(bsa_kernel<D, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bsa_kernel<D, KIND><<<BH * (Sq / BQ), NTHREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), meta, aux, order, Sq, Skv, R, nQ, L, block_q, mask_kind, band_width,
      sink_size, video_len, q_scale);
  return cudaGetLastError();
}

// one instance a kind: none runs the band_sink instance without the predicate
template <int D>
cudaError_t launch_kind(const void* q, const void* k, const void* v, void* o, const int* meta, const int* aux,
                        const int* order, int BH, int Sq, int Skv, int R, int nQ, int L, int block_q, int mask_kind,
                        int band_width, int sink_size, int video_len, float q_scale, cudaStream_t stream) {
  if (mask_kind == KIND_HYVIDEO)
    return launch<D, KIND_HYVIDEO>(q, k, v, o, meta, aux, order, BH, Sq, Skv, R, nQ, L, block_q, mask_kind,
                                   band_width, sink_size, video_len, q_scale, stream);
  if (mask_kind == KIND_COG)
    return launch<D, KIND_COG>(q, k, v, o, meta, aux, order, BH, Sq, Skv, R, nQ, L, block_q, mask_kind, band_width,
                               sink_size, video_len, q_scale, stream);
  return launch<D, KIND_BAND_SINK>(q, k, v, o, meta, aux, order, BH, Sq, Skv, R, nQ, L, block_q, mask_kind,
                                   band_width, sink_size, video_len, q_scale, stream);
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/attention.py): q (BH, Sq, D),
// k/v (BH, Skv, D), o (BH, Sq, D), all bf16 contiguous and 16-byte aligned;
// meta (R, nQ, L) int32; aux (4,) int32 on the device; order (BH * Sq / 128,)
// int32, a permutation of the work items bh * (Sq / 128) + tile;
// Sq % block_q == 0, block_q % 128 == 0, Skv % 128 == 0.
extern "C" int svt_block_sparse_attn(const void* q, const void* k, const void* v, void* o, const void* meta,
                                     const void* aux, const void* order, int BH, int Sq, int Skv, int D, int R,
                                     int nQ, int L, int block_q, int mask_kind, int band_width, int sink_size,
                                     int video_len, float q_scale, void* stream) {
  // chunk extents come from the [lo, hi) windows, so block_kv is not needed
  const int* m = static_cast<const int*>(meta);
  const int* a = static_cast<const int*>(aux);
  const int* ord = static_cast<const int*>(order);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq % BQ || block_q % BQ || Skv % BK) return (int)cudaErrorInvalidValue;
  if (D == 128)
    return (int)launch_kind<128>(q, k, v, o, m, a, ord, BH, Sq, Skv, R, nQ, L, block_q, mask_kind, band_width,
                                 sink_size, video_len, q_scale, s);
  if (D == 64)
    return (int)launch_kind<64>(q, k, v, o, m, a, ord, BH, Sq, Skv, R, nQ, L, block_q, mask_kind, band_width,
                                sink_size, video_len, q_scale, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one K1 CTA at head dim D (0 for a D it does not take)
extern "C" int svt_block_sparse_attn_smem(int D) {
  return D == 128 ? Layout<128>::SMEM : D == 64 ? Layout<64>::SMEM : 0;
}
