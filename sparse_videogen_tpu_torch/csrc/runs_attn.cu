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
// [max(a, s0), min(b, s0 + block_kv)) (ops/metadata.py run_meta). A row
// visits the tokens of its first n chunks, in run order (run_chunks in
// ops/attention.py); n is 0 or every listed run's chunks in SAP's rows.
//
// K3 (mask kind none) packs those tokens (RunBoxes, MODE_PACKED of
// csrc/hopper_attn.cuh): each run is cut into slots of PACK_BOX tokens from
// its first token, and the slots fill the 128-row K/V stages back to back,
// so a stage stages keys of as many runs as fit and a run end leaves at
// most PACK_BOX - 1 masked columns; a run's slots in one stage load as one
// TMA box of 1, 2, 4 or 8 slots each. A chunk walk of 128-aligned tiles would
// stage ~2.6 keys for each live one where key clusters hold ~76 tokens
// (Wan 14B at 720p, KC 1000). ops/attention.py runs_packed_walk is the
// Python model of this walk, runs_packed_stats its counts.
//
// K4 (a MaskSpec, kind band_sink; the wrapper takes no other) keeps the
// chunk walk (RunChunks), since its predicate wants each tile's columns at
// contiguous positions: every chunk starts on a 128-token boundary, only
// its window [lo, hi) cuts a tile, and the predicate is evaluated at (q
// position + aux[2], permuted k position + aux[3]), as the TPU's
// _runs_kernel does. Like the TPU expand kernel, a row takes its full
// chunks (the whole block_kv window live) first and its edge chunks after,
// each in walk order (ops/attention.py runs_tile_walk models it); there is
// no cheap-first split for runs. The TPU kernels expand the runs into an
// SMEM chunk table in a scalar prologue; here the producer thread and both
// consumer warpgroups walk the run list, which needs no table. Either
// order changes only the rounding of the f32 sums.
//
// The CTA body is K1's (csrc/hopper_attn.cuh: 128 q rows, TMA ring of
// 128-row K/V stages, two wgmma consumer warpgroups); the grid runs the
// (head, 128-row q tile) items heaviest first (ops/attention.py
// runs_work_order). runs_stats_kernel also writes the rows' (m, l) softmax
// stats (return_stats, for the ring merge of SAP).

#include "hopper_attn.cuh"

namespace {

// K4's walk of a run-list row: full chunks, then edge chunks, each in run
// order, stopping after the row's n chunks; every chunk is masked
struct RunChunks {
  const int* m;  // the row's entries (a_0, b_0, a_1, ...)
  int n, cap, block_kv;

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
          if ((lo == 0 && hi == block_kv) == (pass == 0)) f(s0, lo, hi, true);
        }
      }
    }
  }
};

// K3's packed walk of a run-list row (MODE_PACKED's source): the tokens of
// the row's first n chunks, run by run, in slots of PACK_BOX from each run's
// first token
struct RunBoxes {
  const int* m;  // the row's entries (a_0, b_0, a_1, ...)
  int n, cap, block_kv;

  // e: the next entry; c: the chunks of the entries before it; [p, b): the
  // current run's tokens not yet in a slot (p == b once the row is done)
  struct Cursor {
    int e, c, p, b;
  };

  // the next run with a token, cut at the row's n chunks
  __device__ __forceinline__ void next_run(Cursor& r) const {
    r.p = r.b = 0;
    for (; r.e < cap && r.c < n; ++r.e) {
      const int a = m[2 * r.e], b = m[2 * r.e + 1];
      const int base = a & ~(SUB - 1);
      const int n_run = (b - base + block_kv - 1) / block_kv;
      const int end = r.c + n_run > n ? min(b, base + (n - r.c) * block_kv) : b;
      r.c += n_run;
      if (end > a) {
        r.p = a;
        r.b = end;
        ++r.e;
        return;
      }
    }
  }
  __device__ __forceinline__ void start(Cursor& r) const {
    r.e = r.c = 0;
    next_run(r);
  }
  __device__ __forceinline__ bool more(const Cursor& r) const { return r.p < r.b; }
  __device__ __forceinline__ void advance(Cursor& r, int slots) const {
    r.p += slots * PACK_BOX;
    if (r.p >= r.b) next_run(r);
  }
};

// K3's K and V maps: boxes of 1, 2, 4 and 8 slots
struct BoxMaps {
  CUtensorMap k[4], v[4];
};

// (BH, rows, D) bf16 as a 3-D tensor map (D, rows, BH) read in 64-column x
// `box`-row boxes with the 128B swizzle: a box's rows past `rows` arrive as
// zeros
bool make_box_map(CUtensorMap* map, const void* ptr, int BH, int rows, int D, int box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(bf16), (cuuint64_t)rows * D * sizeof(bf16)};
  const cuuint32_t boxd[3] = {64, (cuuint32_t)box, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, boxd, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool make_box_maps(BoxMaps* bm, const void* k, const void* v, int BH, int Skv, int D) {
  for (int l = 0; l < 4; ++l)
    if (!make_box_map(&bm->k[l], k, BH, Skv, D, PACK_BOX << l) ||
        !make_box_map(&bm->v[l], v, BH, Skv, D, PACK_BOX << l))
      return false;
  return true;
}

// the CTA of work item `it`: K3 (mask_kind 0) on packed stages from bm, K4
// on chunks from tm_k, tm_v
template <int D, int MODE>
__device__ __forceinline__ void runs_cta(const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                         const BoxMaps* bm, bf16* __restrict__ o, const int* __restrict__ meta,
                                         const int* __restrict__ aux, WorkItem it, int Sq, int Skv, int R, int nQ,
                                         int L, int block_q, int block_kv, int mask_kind, int band_width,
                                         int sink_size, float q_scale, float* __restrict__ m_out,
                                         float* __restrict__ l_out) {
  const int* m = meta + ((size_t)(R == 1 ? 0 : it.bh) * nQ + it.q0 / block_q) * L;
  if (mask_kind == 0) {
    const RunBoxes boxes = {m + 1, m[0], (L - 1) / 2, block_kv};
    attn_cta<D, KIND_BAND_SINK, MODE | MODE_PACKED>(tm_q, bm->k, bm->v, o, boxes, it, Sq, Skv, aux, band_width,
                                                    sink_size, 0, q_scale, 0, 0, m_out, l_out);
  } else {
    const RunChunks chunks = {m + 1, m[0], (L - 1) / 2, block_kv};
    attn_cta<D, KIND_BAND_SINK, MODE>(tm_q, tm_k, tm_v, o, chunks, it, Sq, Skv, aux, band_width, sink_size, 0,
                                      q_scale, 0, 0, m_out, l_out);
  }
}

// runs_kernel that also writes the rows' softmax stats (m, l)
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
runs_stats_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ BoxMaps bm,
                  bf16* __restrict__ o, const int* __restrict__ meta, const int* __restrict__ aux,
                  const int* __restrict__ order, int Sq, int Skv, int R, int nQ, int L, int block_q, int block_kv,
                  int mask_kind, int band_width, int sink_size, float q_scale, float* __restrict__ m_out,
                  float* __restrict__ l_out) {
  runs_cta<D, MODE_STATS>(&tm_q, &tm_k, &tm_v, &bm, o, meta, aux, work_item(order, Sq), Sq, Skv, R, nQ, L, block_q,
                          block_kv, mask_kind, band_width, sink_size, q_scale, m_out, l_out);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
runs_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ BoxMaps bm, bf16* __restrict__ o,
            const int* __restrict__ meta, const int* __restrict__ aux, const int* __restrict__ order, int Sq, int Skv,
            int R, int nQ, int L, int block_q, int block_kv, int mask_kind, int band_width, int sink_size,
            float q_scale) {
  runs_cta<D, 0>(&tm_q, &tm_k, &tm_v, &bm, o, meta, aux, work_item(order, Sq), Sq, Skv, R, nQ, L, block_q, block_kv,
                 mask_kind, band_width, sink_size, q_scale, nullptr, nullptr);
}

template <int D>
cudaError_t launch_runs(const void* q, const void* k, const void* v, void* o, const int* meta, const int* aux,
                        const int* order, int BH, int Sq, int Skv, int R, int nQ, int L, int block_q, int block_kv,
                        int mask_kind, int band_width, int sink_size, float q_scale, float* m_out, float* l_out,
                        cudaStream_t stream) {
  // K3's K and V in boxes of 1, 2, 4, 8 slots, K4's in 128-row tiles
  CUtensorMap tq, tk{}, tv{};
  BoxMaps bm{};
  if (!(make_map(&tq, q, (long long)BH * Sq, D) &&
        (mask_kind == 0 ? make_box_maps(&bm, k, v, BH, Skv, D)
                        : make_map(&tk, k, (long long)BH * Skv, D) && make_map(&tv, v, (long long)BH * Skv, D))))
    return cudaErrorInvalidValue;
  const int smem = Layout<D>::SMEM;
  if (m_out != nullptr) {
    cudaError_t err =
        cudaFuncSetAttribute(runs_stats_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    runs_stats_kernel<D><<<BH * (Sq / BQ), NTHREADS, smem, stream>>>(
        tq, tk, tv, bm, static_cast<bf16*>(o), meta, aux, order, Sq, Skv, R, nQ, L, block_q, block_kv, mask_kind,
        band_width, sink_size, q_scale, m_out, l_out);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(runs_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  runs_kernel<D><<<BH * (Sq / BQ), NTHREADS, smem, stream>>>(tq, tk, tv, bm, static_cast<bf16*>(o), meta, aux, order, Sq,
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
