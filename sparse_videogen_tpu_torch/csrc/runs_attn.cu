// Block-sparse flash attention over run-list metadata, bf16, sm_90a.
//
// Replaces the TPU kernels sparse_videogen_tpu/ops/attention.py::
// _runs_expand_kernel (mask kind "none") and _runs_kernel (its MaskSpec
// path), both behind the entry block_sparse_attention_runs. This is SAP's
// (SVG2's) attention: K and V are permuted cluster-contiguously and unpadded,
// and each (head, q-block) row lists the token runs [a, b) it visits.
//
// Metadata row r = (R == 1 ? 0 : bh), q-block i = (tile * TQ) / block_q:
//   meta[r, i, 0]       = n, the chunk count of the listed runs
//   meta[r, i, 1 + 2e]  = a_e,  meta[r, i, 2 + 2e] = b_e  (runs ascending)
// Run (a, b) splits into ceil((b - base) / block_kv) chunks, base =
// floor128(a); chunk k covers tokens [max(a, base + k*block_kv),
// min(b, base + (k+1)*block_kv)) (ops/metadata.py run_meta). The TPU clamps a
// chunk's DMA start to nsub - block_kv/128 so the copy stays inside the
// array; here the loads are bounds-checked instead and the visited token set
// is the same.
//
// Like the TPU expand kernel, a row takes its full chunks (the whole
// block_kv window live) first and its edge chunks after, each in walk order;
// the order changes only the rounding of the f32 sums. The TPU kernel expands
// the runs into an SMEM chunk table in a scalar prologue; here the CTA walks
// the run list twice (full chunks, then edge chunks), which needs no table.
// With a MaskSpec (kind band_sink; the wrapper takes no other) every chunk also evaluates the token-level
// predicate at (q position + aux[2], permuted k position + aux[3]), as the
// TPU's _runs_kernel does; there is no cheap-first split for runs.
//
// What bounds it on the H100: the tensor-core FLOPs of QK^T and PV over the
// visited pairs. Design: the CTA body of the chunked-CSR kernel
// (csrc/flash_chunk.cuh: 4 warps, 64 q rows, 64-token K/V sub-tiles inside
// each chunk's [lo, hi), mma.sync m16n8k16, P in registers); only the source
// of (base, lo, hi) differs. Synchronous loads, no wgmma yet.

#include "flash_chunk.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(NTHREADS)
runs_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            bf16* __restrict__ o, const int* __restrict__ meta, const int* __restrict__ aux, int Sq, int Skv,
            int R, int nQ, int L, int block_q, int block_kv, int mask_kind, int band_width, int sink_size,
            float q_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + TQ * (D + 8);
  bf16* sV = sK + TK * (D + 8);

  const int tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = tile * TQ;

  const bf16* kb = k + (size_t)bh * Skv * D;
  const bf16* vb = v + (size_t)bh * Skv * D;

  FlashRows<D> st;
  load_q_frags<D>(st, q + ((size_t)bh * Sq + q0) * D, sQ, q_scale, warp, g, t4);

  const int r0 = warp * 16 + g;
  const int row = (R == 1) ? 0 : bh;
  const int* m = meta + ((size_t)row * nQ + q0 / block_q) * L;
  const int n = m[0];
  const int cap = (L - 1) / 2;
  const int qpos[2] = {q0 + r0 + aux[2], q0 + r0 + 8 + aux[2]};
  const bool pred = mask_kind != 0;
  const MaskArgs mk = {band_width, sink_size, 0, 0};

  for (int pass = 0; pass < 2; ++pass) {  // full chunks, then edge chunks
    int c = 0;                            // chunks walked; the row lists n of them
    for (int e = 0; e < cap && c < n; ++e) {
      const int a = m[1 + 2 * e];
      const int b = m[2 + 2 * e];
      const int base = (a / SUB) * SUB;
      const int n_run = (b - base + block_kv - 1) / block_kv;
      for (int kc = 0; kc < n_run && c < n; ++kc, ++c) {
        const int s0 = base + kc * block_kv;
        const int lo = max(a - s0, 0);
        const int hi = min(b - s0, block_kv);
        const bool full = lo == 0 && hi == block_kv;
        if (full != (pass == 0)) continue;
        attend_chunk<D>(st, kb, vb, sK, sV, Skv, s0, lo, hi, pred, qpos, aux[3], mk, g, t4);
      }
    }
  }
  store_rows<D>(st, o + ((size_t)bh * Sq + q0 + r0) * D, t4);
}

template <int D>
cudaError_t launch_runs(const void* q, const void* k, const void* v, void* o, const int* meta, const int* aux,
                        int BH, int Sq, int Skv, int R, int nQ, int L, int block_q, int block_kv, int mask_kind,
                        int band_width, int sink_size, float q_scale, cudaStream_t stream) {
  const int smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(runs_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / TQ, BH);
  runs_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), meta, aux, Sq, Skv, R, nQ, L, block_q, block_kv, mask_kind, band_width, sink_size,
      q_scale);
  return cudaGetLastError();
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/attention.py
// block_sparse_attention_runs): q (BH, Sq, D), k/v (BH, Skv, D), o (BH, Sq,
// D), all bf16 contiguous; meta (R, nQ, L) int32; aux (4,) int32 on the
// device; Sq % block_q == 0, block_q % 64 == 0, block_kv % 128 == 0.
extern "C" int svt_block_sparse_attn_runs(const void* q, const void* k, const void* v, void* o, const void* meta,
                                          const void* aux, int BH, int Sq, int Skv, int D, int R, int nQ, int L,
                                          int block_q, int block_kv, int mask_kind, int band_width, int sink_size,
                                          float q_scale, void* stream) {
  const int* m = static_cast<const int*>(meta);
  const int* a = static_cast<const int*>(aux);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch_runs<128>(q, k, v, o, m, a, BH, Sq, Skv, R, nQ, L, block_q, block_kv, mask_kind,
                                 band_width, sink_size, q_scale, s);
  if (D == 64)
    return (int)launch_runs<64>(q, k, v, o, m, a, BH, Sq, Skv, R, nQ, L, block_q, block_kv, mask_kind, band_width,
                                sink_size, q_scale, s);
  return (int)cudaErrorInvalidValue;
}
