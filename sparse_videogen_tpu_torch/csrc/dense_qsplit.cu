// Dense flash attention, bf16, sm_90a (K7).
//
// Replaces the TPU kernel scripts/bench_qsplit.py::_kernel (entry dense_attn),
// a probe of whether independent q sub-tiles, each with its own online-softmax
// state, overlap one sub-tile's softmax with another's products. Its numerics:
// q pre-scaled by D^-1/2 in f32 and rounded to bf16; natural-exp online
// softmax in f32 (evaluated as exp2(s * log2 e - m * log2 e), one FFMA an
// argument); P rounded to bf16 for PV while the row sum uses the f32 P;
// out = acc / max(l, 1e-20). Separate K and V: the TPU's packed [K|V] rows
// and its nbuf DMA semaphores are TPU choices.
//
// What bounds it on the H100: the tensor-core FLOPs, 4 * S * S * D per head.
// Design: K1's Hopper CTA body (csrc/hopper_attn.cuh) with a dense chunk
// source, one unmasked chunk [0, S) a row, and K7's numerics (MODE_NAT): a
// TMA producer warpgroup keeps 128-token K/V tiles in flight, two consumer
// warpgroups of 64 q rows each run wgmma over every tile. The TPU probe's
// q-split maps onto those two warpgroups, which are its independent
// sub-tiles: a CTA owns bq = 128 rows, and
//   qsplit = 1  runs them on K1's schedule (each warpgroup: QK^T, softmax,
//               PV, one tile after the other; the baseline),
//   qsplit = 2  runs them in ping-pong (MODE_PINGPONG, FA3's schedule): one
//               warpgroup's softmax under the other's products, and inside a
//               warpgroup tile n's softmax under tile n-1's PV.
// Work items (head, 128-row tile) all weigh the same, so the grid runs them
// in order: neighbouring CTAs read the same head's K/V from L2.

#include "hopper_attn.cuh"

namespace {

__device__ const int kNoAux[4] = {0, 0, 0, 0};  // no mask, no position offsets

// one unmasked chunk over the whole K/V row
struct DenseChunks {
  int S;

  template <class F>
  __device__ __forceinline__ void walk(F&& f) const {
    f(0, 0, S, false);
  }
};

template <int D, int MODE>
__global__ void __launch_bounds__(NTHREADS, 1)
dense_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int S, float q_scale) {
  const int nT = S / BQ;
  const WorkItem it = {(int)blockIdx.x / nT, ((int)blockIdx.x % nT) * BQ};
  const DenseChunks chunks = {S};
  attn_cta<D, KIND_BAND_SINK, MODE>(&tm_q, &tm_k, &tm_v, o, chunks, it, S, S, kNoAux, 0, 0, 0, q_scale);
}

template <int D, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int S, float q_scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_qkv_maps(&tq, &tk, &tv, q, k, v, BH, S, S, D)) return cudaErrorInvalidValue;
  const int smem = Layout<D, (MODE & MODE_PINGPONG) != 0>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(dense_kernel<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dense_kernel<D, MODE><<<BH * (S / BQ), NTHREADS, smem, stream>>>(tq, tk, tv, static_cast<bf16*>(o), S, q_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int BH, int S, int qsplit, float q_scale,
                     cudaStream_t s) {
  if (qsplit == 1) return launch<D, MODE_NAT>(q, k, v, o, BH, S, q_scale, s);
  if (qsplit == 2) return launch<D, MODE_NAT | MODE_PINGPONG>(q, k, v, o, BH, S, q_scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/dense_qsplit.py): q, k, v, o
// (BH, S, D) bf16 contiguous and 16-byte aligned; S % 128 == 0; bq == 128,
// qsplit 1 or 2 (KERNEL_CONFIGS).
extern "C" int svt_dense_qsplit(const void* q, const void* k, const void* v, void* o, int BH, int S, int D, int bq,
                                int qsplit, float q_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bq != BQ || S % BQ || S <= 0) return (int)cudaErrorInvalidValue;
  if (D == 128) return (int)dispatch<128>(q, k, v, o, BH, S, qsplit, q_scale, s);
  if (D == 64) return (int)dispatch<64>(q, k, v, o, BH, S, qsplit, q_scale, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one K7 CTA (0 for a configuration it does not take)
extern "C" int svt_dense_qsplit_smem(int D, int qsplit) {
  if (D != 64 && D != 128) return 0;
  if (qsplit == 1) return D == 128 ? Layout<128>::SMEM : Layout<64>::SMEM;
  if (qsplit == 2) return D == 128 ? Layout<128, true>::SMEM : Layout<64, true>::SMEM;
  return 0;
}
