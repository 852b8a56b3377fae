// Block-sparse flash attention over chunked-CSR metadata, bf16, sm_90a (K1).
//
// Replaces the TPU kernel sparse_videogen_tpu/ops/attention.py::_kernel
// (entry block_sparse_attention_kv). Same metadata (ops/metadata.py), same
// MaskSpec semantics (kinds "none", "band_sink", "hyvideo" and "cog", global
// positions offset by aux[2]/aux[3], hyvideo's real length or cog's prompt
// length in aux[0]; placement-free SVG1's dual per-head spec, band_sink or
// band_sink_perm by aux[4 + bh], below; csrc/mask_pred.cuh), the optional (m, l)
// softmax stats of return_stats, same numerics: q pre-scaled by
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

// bsa_kernel that also writes the rows' softmax stats (m, l)
template <int D, int KIND>
__global__ void __launch_bounds__(NTHREADS, 1)
bsa_stats_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, const int* __restrict__ meta,
                 const int* __restrict__ aux, const int* __restrict__ order, int Sq, int Skv, int R, int nQ, int L,
                 int block_q, int mask_kind, int band_width, int sink_size, int video_len, float q_scale,
                 float* __restrict__ m_out, float* __restrict__ l_out) {
  const WorkItem it = work_item(order, Sq);
  const int* m = meta + ((size_t)(R == 1 ? 0 : it.bh) * nQ + it.q0 / block_q) * L;
  const CsrChunks chunks = {m, m[0] % N_CHEAP_SCALE, m[0] / N_CHEAP_SCALE, mask_kind};
  attn_cta<D, KIND, MODE_STATS>(&tm_q, &tm_k, &tm_v, o, chunks, it, Sq, Skv, aux, band_width, sink_size, video_len,
                                q_scale, 0, 0, m_out, l_out);
}

// The dual per-head spec of placement-free SVG1 (the dual branch of
// sparse_videogen_tpu/ops/attention.py::_kernel, ops/mask_spec.py:58-62):
// aux[4 + bh] == 1 marks a temporal head, whose mask is band_sink_perm, the
// band and sink at the permuted positions p(x) = (x % fs) * F + x / fs; a
// spatial head (0) runs band_sink on its metadata row, as bsa_kernel does.
//
// In original order a 128-token tile's p-set is strided by F over
// thousands of positions, so almost every tile would straddle the band's
// edge; in p-order the mask is a plain band and sink. So a temporal head's
// items are q slabs, and its tiles K/V slabs, of n_s = 128 / F slots x all F
// frames, read from the original layout by one TMA box of a 4-D map each
// (MODE_SLAB of csrc/hopper_attn.cuh): a slab is the contiguous p-interval
// [slab * P, slab * P + P), P = n_s * F (126 of 128 rows at F = 21), the
// interior slabs of the band are TILE_ALL and only the band's edge slabs and
// the sink's last one run the predicate. Its walk is its row of slab_meta
// (ops/metadata.py slab_meta_np: the band + sink skeleton on p at slab
// granularity, (n, a_0, b_0, a_1, b_1), runs [a, b) of K/V slabs); its row
// in `meta` is the plain version's (the wrapper refuses rows under which
// that attends other pairs), and the q padding past the video comes out as
// rows that saw no column.
//
// Items: bh * n_items + t, t < Sq / 128 (a spatial head's 128-row tiles) or
// t < ceil(fs / n_s) (a temporal head's slabs); `order` lists all BH *
// n_items of them heaviest first, and an item past its head's count exits
// at once. A head's class is uniform over its items, so the CTA takes one
// of the two bodies once, before any load; no branch lies between a
// wgmma's issue and its wait. MODE is 0 or MODE_STATS.
constexpr int SLAB_META_LEN = 5;

// K/V slabs of a temporal item: for each run [a, b) of its slab_meta row,
// chunk `slab` with live columns [0, min(P, S - slab * P)) (the last slab
// may run past the video's last slot)
struct SlabChunks {
  const int* m;  // (n, a_0, b_0, a_1, b_1)
  int P, S;

  template <class F>
  __device__ __forceinline__ void walk(F&& f) const {
    for (int c = 0; c < m[0]; ++c)
      for (int slab = m[1 + 2 * c]; slab < m[2 + 2 * c]; ++slab) f(slab, 0, min(P, S - slab * P), true);
  }
};

template <int D, int MODE>
__global__ void __launch_bounds__(NTHREADS, 1)
bsa_dual_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap ts_q,
                const __grid_constant__ CUtensorMap ts_k, const __grid_constant__ CUtensorMap ts_v,
                bf16* __restrict__ o, const int* __restrict__ meta, const int* __restrict__ slab_meta,
                const int* __restrict__ aux, const int* __restrict__ order, int Sq, int Skv, int R, int nQ, int L,
                int block_q, int n_items, int band_width, int sink_size, int frame_size, int num_frames,
                float q_scale, float* __restrict__ m_out, float* __restrict__ l_out) {
  const int item = order[blockIdx.x];
  const int bh = item / n_items, t = item % n_items;
  if (aux[4 + bh] == 1) {
    const int P = (BQ / num_frames) * num_frames;
    if (t >= (frame_size + BQ / num_frames - 1) / (BQ / num_frames)) return;
    const SlabChunks chunks = {slab_meta + t * SLAB_META_LEN, P, frame_size * num_frames};
    attn_cta<D, KIND_BAND_SINK, MODE | MODE_SLAB>(&ts_q, &ts_k, &ts_v, o, chunks, {bh, t * P}, Sq, Skv, aux,
                                                  band_width, sink_size, 0, q_scale, frame_size, num_frames, m_out,
                                                  l_out);
  } else {
    if (t >= Sq / BQ) return;
    const int* m = meta + ((size_t)(R == 1 ? 0 : bh) * nQ + t * BQ / block_q) * L;
    const CsrChunks chunks = {m, m[0] % N_CHEAP_SCALE, m[0] / N_CHEAP_SCALE, KIND_BAND_SINK};
    attn_cta<D, KIND_BAND_SINK, MODE>(&tm_q, &tm_k, &tm_v, o, chunks, {bh, t * BQ}, Sq, Skv, aux, band_width,
                                      sink_size, 0, q_scale, 0, 0, m_out, l_out);
  }
}

// what one call hands the kernels (C entry below)
struct Call {
  const void *q, *k, *v;
  void* o;
  const int *meta, *slab_meta, *aux, *order;
  int BH, Sq, Skv, R, nQ, L, block_q, mask_kind, band_width, sink_size, video_len, frame_size, num_frames, n_items;
  float q_scale;
  float *m_out, *l_out;  // both null: no stats
  cudaStream_t stream;
};

// launch `kernel` over the call's (head, 128-row tile) items with K1's CTA
template <int D, class Kernel, class... Args>
cudaError_t launch_items(Kernel kernel, const Call& c, Args... args) {
  const int smem = Layout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<c.BH * c.n_items, NTHREADS, smem, c.stream>>>(args...);
  return cudaGetLastError();
}

// the 4-D map of a temporal head's slabs over x (BH, rows, D) bf16 holding
// the video as frame_size tokens a frame: dimensions (D, frame, slot,
// batch*head), the frame fastest in the box (64 columns, F frames, n_s
// slots), so a slab lands in p-order; 128B swizzle as the 2-D maps
bool make_slab_map(CUtensorMap* map, const void* ptr, int BH, int rows, int frame_size, int num_frames, int D) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)num_frames, (cuuint64_t)frame_size, (cuuint64_t)BH};
  const cuuint64_t strides[3] = {(cuuint64_t)frame_size * D * sizeof(bf16), (cuuint64_t)D * sizeof(bf16),
                                 (cuuint64_t)rows * D * sizeof(bf16)};
  const cuuint32_t box[4] = {64, (cuuint32_t)num_frames, (cuuint32_t)(BQ / num_frames), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int KIND>
cudaError_t launch_kind(const Call& c, const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv) {
  bf16* o = static_cast<bf16*>(c.o);
  if (c.m_out == nullptr)
    return launch_items<D>(bsa_kernel<D, KIND>, c, tq, tk, tv, o, c.meta, c.aux, c.order, c.Sq, c.Skv, c.R, c.nQ,
                           c.L, c.block_q, c.mask_kind, c.band_width, c.sink_size, c.video_len, c.q_scale);
  return launch_items<D>(bsa_stats_kernel<D, KIND>, c, tq, tk, tv, o, c.meta, c.aux, c.order, c.Sq, c.Skv, c.R,
                         c.nQ, c.L, c.block_q, c.mask_kind, c.band_width, c.sink_size, c.video_len, c.q_scale,
                         c.m_out, c.l_out);
}

// one instance a kind (none runs the band_sink instance without the
// predicate); KIND_BAND_SINK_PERM runs the dual kernel
template <int D>
cudaError_t launch(const Call& c) {
  CUtensorMap tq, tk, tv;
  if (!make_qkv_maps(&tq, &tk, &tv, c.q, c.k, c.v, c.BH, c.Sq, c.Skv, D)) return cudaErrorInvalidValue;
  if (c.mask_kind == KIND_HYVIDEO) return launch_kind<D, KIND_HYVIDEO>(c, tq, tk, tv);
  if (c.mask_kind == KIND_COG) return launch_kind<D, KIND_COG>(c, tq, tk, tv);
  if (c.mask_kind == KIND_BAND_SINK_PERM) {
    CUtensorMap sq, sk, sv;
    if (!make_slab_map(&sq, c.q, c.BH, c.Sq, c.frame_size, c.num_frames, D) ||
        !make_slab_map(&sk, c.k, c.BH, c.Skv, c.frame_size, c.num_frames, D) ||
        !make_slab_map(&sv, c.v, c.BH, c.Skv, c.frame_size, c.num_frames, D))
      return cudaErrorInvalidValue;
    bf16* o = static_cast<bf16*>(c.o);
    auto kernel = c.m_out == nullptr ? bsa_dual_kernel<D, 0> : bsa_dual_kernel<D, MODE_STATS>;
    return launch_items<D>(kernel, c, tq, tk, tv, sq, sk, sv, o, c.meta, c.slab_meta, c.aux, c.order, c.Sq, c.Skv,
                           c.R, c.nQ, c.L, c.block_q, c.n_items, c.band_width, c.sink_size, c.frame_size,
                           c.num_frames, c.q_scale, c.m_out, c.l_out);
  }
  return launch_kind<D, KIND_BAND_SINK>(c, tq, tk, tv);
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/attention.py): q (BH, Sq, D),
// k/v (BH, Skv, D), o (BH, Sq, D), all bf16 contiguous and 16-byte aligned;
// meta (R, nQ, L) int32; aux (4,) int32 on the device, (4 + BH,) with
// mask_kind KIND_BAND_SINK_PERM (aux[4 + bh]: 1 for a band_sink_perm head, 0
// for a band_sink one; aux[2:4] must be 0); order (BH * n_items,) int32, a
// permutation of the work items bh * n_items + t (n_items = Sq / 128 but with
// KIND_BAND_SINK_PERM, where slab_meta is (ceil(fs / n_s), 5) int32 and
// n_items = max(Sq / 128, ceil(fs / n_s))); Sq % block_q == 0, block_q % 128
// == 0, Skv % 128 == 0; m_out and l_out null, or both (BH, Sq) f32 for the
// stats; with KIND_BAND_SINK_PERM 8 < frame_size, num_frames <= 128 and
// frame_size * num_frames <= Sq, Skv.
extern "C" int svt_block_sparse_attn(const void* q, const void* k, const void* v, void* o, const void* meta,
                                     const void* slab_meta, const void* aux, const void* order, int BH, int Sq,
                                     int Skv, int D, int R, int nQ, int L, int block_q, int mask_kind,
                                     int band_width, int sink_size, int video_len, int frame_size, int num_frames,
                                     int n_items, float q_scale, void* m_out, void* l_out, void* stream) {
  // chunk extents come from the [lo, hi) windows, so block_kv is not needed
  const Call c = {q, k, v, o, static_cast<const int*>(meta), static_cast<const int*>(slab_meta),
                  static_cast<const int*>(aux), static_cast<const int*>(order), BH, Sq, Skv, R, nQ, L, block_q,
                  mask_kind, band_width, sink_size, video_len, frame_size, num_frames,
                  mask_kind == KIND_BAND_SINK_PERM ? n_items : Sq / BQ, q_scale, static_cast<float*>(m_out),
                  static_cast<float*>(l_out), static_cast<cudaStream_t>(stream)};
  if (Sq % BQ || block_q % BQ || Skv % BK || (m_out == nullptr) != (l_out == nullptr)) return (int)cudaErrorInvalidValue;
  if (mask_kind == KIND_BAND_SINK_PERM &&
      (frame_size <= 8 || num_frames < 1 || num_frames > BQ || frame_size * num_frames > Sq ||
       frame_size * num_frames > Skv || n_items < Sq / BQ || slab_meta == nullptr))
    return (int)cudaErrorInvalidValue;
  if (D == 128) return (int)launch<128>(c);
  if (D == 64) return (int)launch<64>(c);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one K1 CTA at head dim D (0 for a D it does not take)
extern "C" int svt_block_sparse_attn_smem(int D) {
  return D == 128 ? Layout<128>::SMEM : D == 64 ? Layout<64>::SMEM : 0;
}
