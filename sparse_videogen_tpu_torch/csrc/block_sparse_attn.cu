// Block-sparse flash attention over chunked-CSR metadata, bf16, sm_90a.
//
// Replaces the TPU kernel sparse_videogen_tpu/ops/attention.py::_kernel
// (entry block_sparse_attention_kv). Same metadata (ops/metadata.py), same
// MaskSpec semantics (kinds "none", "band_sink", "hyvideo" and "cog", global
// positions offset by aux[2]/aux[3], hyvideo's real length or cog's prompt
// length in aux[0]), same numerics (csrc/flash_chunk.cuh).
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
// (16 per warp) for a (batch*head, q tile) pair and walks the row's CSR
// chunks with the shared per-chunk body (attend_chunk, csrc/flash_chunk.cuh):
// 64-token sub-tiles inside [lo, hi) staged in shared memory, mma.sync
// m16n8k16 products, P kept in registers. Loads are synchronous and the
// products use mma.sync, not wgmma: the simple, correct first version;
// several resident CTAs per SM hide part of the load latency.

#include "flash_chunk.cuh"

namespace {

constexpr int ENTRY_SCALE = 2048;
constexpr int N_CHEAP_SCALE = 4096;

template <int D, int KIND>
__global__ void __launch_bounds__(NTHREADS)
bsa_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           bf16* __restrict__ o, const int* __restrict__ meta, const int* __restrict__ aux,
           int Sq, int Skv, int R, int nQ, int L, int block_q, int mask_kind, int band_width,
           int sink_size, int video_len, float q_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + TQ * (D + 8);
  bf16* sV = sK + TK * (D + 8);

  const int tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread in group
  const int q0 = tile * TQ;

  const bf16* kb = k + (size_t)bh * Skv * D;
  const bf16* vb = v + (size_t)bh * Skv * D;

  FlashRows<D> st;
  load_q_frags<D>(st, q + ((size_t)bh * Sq + q0) * D, sQ, q_scale, warp, g, t4);

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int row = (R == 1) ? 0 : bh;
  const int* m = meta + ((size_t)row * nQ + q0 / block_q) * L;
  const int e0 = m[0];
  const int n = e0 % N_CHEAP_SCALE;
  const int n_cheap = e0 / N_CHEAP_SCALE;
  const int qpos[2] = {q0 + r0 + aux[2], q0 + r0 + 8 + aux[2]};
  const MaskArgs mk = {band_width, sink_size, video_len, KIND == KIND_BAND_SINK ? 0 : aux[0]};

  for (int c = 0; c < n; ++c) {
    const int win = m[2 + 2 * c];
    attend_chunk<D, KIND>(st, kb, vb, sK, sV, Skv, m[1 + 2 * c] * SUB, win / ENTRY_SCALE, win % ENTRY_SCALE,
                    mask_kind != 0 && c >= n_cheap, qpos, aux[3], mk, g, t4);
  }
  store_rows<D>(st, o + ((size_t)bh * Sq + q0 + r0) * D, t4);
}

template <int D, int KIND>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* meta, const int* aux,
                   int BH, int Sq, int Skv, int R, int nQ, int L, int block_q, int mask_kind,
                   int band_width, int sink_size, int video_len, float q_scale, cudaStream_t stream) {
  const int smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(bsa_kernel<D, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / TQ, BH);
  bsa_kernel<D, KIND><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), meta, aux, Sq, Skv, R, nQ, L, block_q, mask_kind, band_width, sink_size,
      video_len, q_scale);
  return cudaGetLastError();
}

// the text kinds have their own instances: the none/band_sink instance keeps
// the registers it had before they existed
template <int D>
cudaError_t launch_kind(const void* q, const void* k, const void* v, void* o, const int* meta, const int* aux,
                        int BH, int Sq, int Skv, int R, int nQ, int L, int block_q, int mask_kind, int band_width,
                        int sink_size, int video_len, float q_scale, cudaStream_t stream) {
  if (mask_kind == KIND_HYVIDEO)
    return launch<D, KIND_HYVIDEO>(q, k, v, o, meta, aux, BH, Sq, Skv, R, nQ, L, block_q, mask_kind, band_width,
                                   sink_size, video_len, q_scale, stream);
  if (mask_kind == KIND_COG)
    return launch<D, KIND_COG>(q, k, v, o, meta, aux, BH, Sq, Skv, R, nQ, L, block_q, mask_kind, band_width,
                               sink_size, video_len, q_scale, stream);
  return launch<D, KIND_BAND_SINK>(q, k, v, o, meta, aux, BH, Sq, Skv, R, nQ, L, block_q, mask_kind, band_width,
                                   sink_size, video_len, q_scale, stream);
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/attention.py): q (BH, Sq, D),
// k/v (BH, Skv, D), o (BH, Sq, D), all bf16 contiguous; meta (R, nQ, L)
// int32; aux (4,) int32 on the device; Sq % block_q == 0, block_q % 64 == 0.
extern "C" int svt_block_sparse_attn(const void* q, const void* k, const void* v, void* o,
                                     const void* meta, const void* aux, int BH, int Sq, int Skv, int D,
                                     int R, int nQ, int L, int block_q, int mask_kind, int band_width,
                                     int sink_size, int video_len, float q_scale, void* stream) {
  // chunk extents come from the [lo, hi) windows, so block_kv is not needed
  const int* m = static_cast<const int*>(meta);
  const int* a = static_cast<const int*>(aux);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch_kind<128>(q, k, v, o, m, a, BH, Sq, Skv, R, nQ, L, block_q, mask_kind, band_width, sink_size,
                                 video_len, q_scale, s);
  if (D == 64)
    return (int)launch_kind<64>(q, k, v, o, m, a, BH, Sq, Skv, R, nQ, L, block_q, mask_kind, band_width, sink_size,
                                video_len, q_scale, s);
  return (int)cudaErrorInvalidValue;
}
