// Block-sparse flash attention over run-list metadata, bf16, sm_90a (K3/K4).
//
// Replaces the TPU kernels sparse_videogen_tpu/ops/attention.py::
// _runs_expand_kernel (mask kind "none") and _runs_kernel (its MaskSpec
// path), both behind the entry block_sparse_attention_runs. This is SAP's
// (SVG2's) attention: K and V are permuted cluster-contiguously and unpadded,
// and each (head, q-block) row lists the token runs [a, b) it visits.
//
// Metadata row r = (R == 1 ? 0 : bh), q-block i = (tile * BQ) / block_q:
//   meta[r, i, 0]       = n, the chunk count of the listed runs
//   meta[r, i, 1 + 2e]  = a_e,  meta[r, i, 2 + 2e] = b_e  (runs ascending;
//                         unused entries (0, 0))
// Run (a, b) splits into ceil((b - base) / block_kv) chunks, base =
// floor128(a); chunk k starts at s0 = base + k*block_kv and covers tokens
// [max(a, s0), min(b, s0 + block_kv)) (ops/metadata.py run_meta). Every
// chunk therefore starts on a 128-token boundary, like a chunked-CSR chunk,
// and only its window [lo, hi) cuts a tile. The TPU clamps a chunk's DMA
// start to nsub - block_kv/128 so the copy stays inside the array; here a
// tile is loaded only below hi <= Skv and the visited token set is the same.
//
// Like the TPU expand kernel, a row takes its full chunks (the whole
// block_kv window live) first and its edge chunks after, each in walk order;
// the order changes only the rounding of the f32 sums. The TPU kernel expands
// the runs into an SMEM chunk table in a scalar prologue; here the producer
// thread and both consumer warpgroups walk the run list twice (full chunks,
// then edge chunks), which needs no table (ops/attention.py runs_tile_walk is
// the Python model of this walk). With a MaskSpec (kind band_sink; the
// wrapper takes no other) every chunk also evaluates the token-level
// predicate at (q position + aux[2], permuted k position + aux[3]), as the
// TPU's _runs_kernel does; there is no cheap-first split for runs.
//
// The CTA body is K1's (csrc/hopper_attn.cuh: 128 q rows, TMA ring of
// 128-token tiles, two wgmma consumer warpgroups, mask_tile classification);
// the grid runs the (head, 128-row q tile) items heaviest first
// (ops/attention.py runs_work_order). runs_stats_kernel also writes the
// rows' (m, l) softmax stats (return_stats, for the ring merge of SAP).

#include "hopper_attn.cuh"

namespace {

// the two-pass walk of a run-list row: full chunks, then edge chunks, each
// in run order, stopping after the row's n chunks
struct RunChunks {
  const int* m;  // the row's entries (a_0, b_0, a_1, ...)
  int n, cap, block_kv;
  bool mask;

  template <class F>
  __device__ __forceinline__ void walk(F&& f) const {
    for (int pass = 0; pass < 2; ++pass) {
      int c = 0;  // chunks walked; the row lists n of them
      for (int e = 0; e < cap && c < n; ++e) {
        const int a = m[2 * e], b = m[2 * e + 1];
        const int base = a & ~(SUB - 1);
        const int n_run = (b - base + block_kv - 1) / block_kv;
        for (int kc = 0; kc < n_run && c < n; ++kc, ++c) {
          const int s0 = base + kc * block_kv;
          const int lo = max(a - s0, 0), hi = min(b - s0, block_kv);
          if ((lo == 0 && hi == block_kv) == (pass == 0)) f(s0, lo, hi, mask);
        }
      }
    }
  }
};

// runs_kernel that also writes the rows' softmax stats (m, l)
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
runs_stats_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, const int* __restrict__ meta,
                  const int* __restrict__ aux, const int* __restrict__ order, int Sq, int Skv, int R, int nQ, int L,
                  int block_q, int block_kv, int mask_kind, int band_width, int sink_size, float q_scale,
                  float* __restrict__ m_out, float* __restrict__ l_out) {
  const WorkItem it = work_item(order, Sq);
  const int* m = meta + ((size_t)(R == 1 ? 0 : it.bh) * nQ + it.q0 / block_q) * L;
  const RunChunks chunks = {m + 1, m[0], (L - 1) / 2, block_kv, mask_kind != 0};
  attn_cta<D, KIND_BAND_SINK, MODE_STATS>(&tm_q, &tm_k, &tm_v, o, chunks, it, Sq, Skv, aux, band_width, sink_size,
                                          0, q_scale, 0, 0, m_out, l_out);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
runs_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, const int* __restrict__ meta,
            const int* __restrict__ aux, const int* __restrict__ order, int Sq, int Skv, int R, int nQ, int L,
            int block_q, int block_kv, int mask_kind, int band_width, int sink_size, float q_scale) {
  const WorkItem it = work_item(order, Sq);
  const int* m = meta + ((size_t)(R == 1 ? 0 : it.bh) * nQ + it.q0 / block_q) * L;
  const RunChunks chunks = {m + 1, m[0], (L - 1) / 2, block_kv, mask_kind != 0};
  attn_cta<D, KIND_BAND_SINK>(&tm_q, &tm_k, &tm_v, o, chunks, it, Sq, Skv, aux, band_width, sink_size, 0, q_scale);
}

template <int D>
cudaError_t launch_runs(const void* q, const void* k, const void* v, void* o, const int* meta, const int* aux,
                        const int* order, int BH, int Sq, int Skv, int R, int nQ, int L, int block_q, int block_kv,
                        int mask_kind, int band_width, int sink_size, float q_scale, float* m_out, float* l_out,
                        cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_qkv_maps(&tq, &tk, &tv, q, k, v, BH, Sq, Skv, D)) return cudaErrorInvalidValue;
  const int smem = Layout<D>::SMEM;
  if (m_out != nullptr) {
    cudaError_t err =
        cudaFuncSetAttribute(runs_stats_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    runs_stats_kernel<D><<<BH * (Sq / BQ), NTHREADS, smem, stream>>>(
        tq, tk, tv, static_cast<bf16*>(o), meta, aux, order, Sq, Skv, R, nQ, L, block_q, block_kv, mask_kind,
        band_width, sink_size, q_scale, m_out, l_out);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(runs_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  runs_kernel<D><<<BH * (Sq / BQ), NTHREADS, smem, stream>>>(tq, tk, tv, static_cast<bf16*>(o), meta, aux, order, Sq,
                                                             Skv, R, nQ, L, block_q, block_kv, mask_kind, band_width,
                                                             sink_size, q_scale);
  return cudaGetLastError();
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/attention.py
// block_sparse_attention_runs): q (BH, Sq, D), k/v (BH, Skv, D), o (BH, Sq,
// D), all bf16 contiguous and 16-byte aligned; meta (R, nQ, L) int32; aux
// (4,) int32 on the device; order (BH * Sq / 128,) int32, a permutation of
// the work items bh * (Sq / 128) + tile; Sq % block_q == 0, block_q % 128 ==
// 0, Skv % 128 == 0, block_kv % 128 == 0; mask_kind 0 (none) or band_sink;
// m_out and l_out null, or both (BH, Sq) f32 for the softmax stats.
extern "C" int svt_block_sparse_attn_runs(const void* q, const void* k, const void* v, void* o, const void* meta,
                                          const void* aux, const void* order, int BH, int Sq, int Skv, int D, int R,
                                          int nQ, int L, int block_q, int block_kv, int mask_kind, int band_width,
                                          int sink_size, float q_scale, void* m_out, void* l_out, void* stream) {
  const int* m = static_cast<const int*>(meta);
  const int* a = static_cast<const int*>(aux);
  const int* ord = static_cast<const int*>(order);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  if (Sq % BQ || block_q % BQ || Skv % BK || block_kv % BK || (mask_kind != 0 && mask_kind != KIND_BAND_SINK) ||
      (mo == nullptr) != (lo == nullptr))
    return (int)cudaErrorInvalidValue;
  if (D == 128)
    return (int)launch_runs<128>(q, k, v, o, m, a, ord, BH, Sq, Skv, R, nQ, L, block_q, block_kv, mask_kind,
                                 band_width, sink_size, q_scale, mo, lo, s);
  if (D == 64)
    return (int)launch_runs<64>(q, k, v, o, m, a, ord, BH, Sq, Skv, R, nQ, L, block_q, block_kv, mask_kind,
                                band_width, sink_size, q_scale, mo, lo, s);
  return (int)cudaErrorInvalidValue;
}
