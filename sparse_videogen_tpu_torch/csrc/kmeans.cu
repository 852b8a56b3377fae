// One fused k-means Lloyd pass, bf16 tokens, f32 sums, sm_90a.
//
// Replaces the TPU kernel sparse_videogen_tpu/ops/kmeans_pallas.py::_kernel
// (entry kmeans_assign_update). For x (B, N, D) and centroids c (B, K, D):
//   labels[b, n] = argmin_k (|c_k|^2 - 2 x_n . c_k), ties to the first k
//   sums[b, k]   = sum of the x_n labelled k (f32),  counts[b, k] = their number
// |x_n|^2 is left out of the distance, as the TPU kernel does (it cannot
// change the argmin). The TPU pads K to 128 lanes with +inf distances and N
// to its block; here the kernel only visits k < K and tokens n < N.
//
// What bounds it on the H100: at the SAP shapes (B = 12 heads, N = 32,760,
// D = 128, K = 50 or 200) the x . c^T product is 0.4-1.7 GFLOP a head on the
// tensor cores and x is read once (8 MB a head), so it is short either way;
// what costs is keeping the update deterministic. Float atomics would give
// other bits on every run, and the next iteration's labels follow the
// centroids, so the update is done in a fixed order:
//   kernel 1, one CTA per (slab of tokens, b), 4 warps: the centroids (K
//     rounded up to 64, bf16) and |c|^2 stay in shared memory; the slab is
//     walked in 64-token tiles. A tile's x . c^T runs on bf16 tensor cores
//     (mma.sync m16n8k16, f32 accumulate; the same fragment layout as the
//     attention kernels' QK^T), each thread keeps a running argmin over its
//     columns in ascending k with a strict <, and the four threads of a row
//     merge theirs, smaller index on a tie. Then thread d adds column d of
//     the tile's tokens, in token order, into the slab's f32 (K, D) sums in
//     shared memory; counts are integer shared-memory atomics (exact in any
//     order). The slab writes its partial sums and counts.
//   kernel 2 adds the slabs' partials in slab order.
// The slab count depends only on B, N and the card's SM count, so the same
// inputs give the same bits on every run on the same card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TN = 64;         // tokens per assign tile (16 rows per warp)
constexpr int NTHREADS = 128;  // 4 warps
constexpr int KCHUNK = 64;     // centroid columns per pass of the argmin (8 n-tiles)

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

int slab_len(int N, int n_slabs) { return round_up((N + n_slabs - 1) / n_slabs, TN); }

size_t smem_bytes(int K, int D) {
  const int k_pad = round_up(K, KCHUNK);
  return (size_t)k_pad * (D + 8) * sizeof(bf16)  // centroids
         + (size_t)K * D * sizeof(float)          // slab sums
         + (size_t)TN * (D + 8) * sizeof(bf16)    // x tile
         + (size_t)k_pad * sizeof(float)          // |c|^2
         + (size_t)k_pad * sizeof(int)            // slab counts
         + (size_t)TN * sizeof(int);              // tile labels
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
kmeans_slab_kernel(const bf16* __restrict__ x, const bf16* __restrict__ c, int* __restrict__ labels,
                   float* __restrict__ part_sums, int* __restrict__ part_counts, int N, int K, int slab) {
  constexpr int LD = D + 8;
  constexpr int VPR = D / 8;
  const int k_pad = round_up(K, KCHUNK);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);
  float* sSum = reinterpret_cast<float*>(sC + (size_t)k_pad * LD);
  bf16* sX = reinterpret_cast<bf16*>(sSum + (size_t)K * D);
  float* sCsq = reinterpret_cast<float*>(sX + TN * LD);
  int* sCnt = reinterpret_cast<int*>(sCsq + k_pad);
  int* sLab = sCnt + k_pad;

  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int n_slabs = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bf16* xb = x + (size_t)b * N * D;
  const bf16* cb = c + (size_t)b * K * D;

  for (int i = threadIdx.x; i < k_pad * VPR; i += NTHREADS) {
    const int r = i / VPR, col = (i % VPR) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r < K) raw = *reinterpret_cast<const uint4*>(cb + (size_t)r * D + col);
    *reinterpret_cast<uint4*>(sC + r * LD + col) = raw;
  }
  for (int i = threadIdx.x; i < K * D; i += NTHREADS) sSum[i] = 0.f;
  for (int i = threadIdx.x; i < k_pad; i += NTHREADS) sCnt[i] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < k_pad; r += NTHREADS) {
    float acc = 0.f;
    for (int d = 0; d < D; ++d) {
      const float e = __bfloat162float(sC[r * LD + d]);
      acc = __fadd_rn(acc, __fmul_rn(e, e));
    }
    sCsq[r] = acc;
  }
  __syncthreads();

  const int t_begin = s * slab;
  const int t_end = min(N, t_begin + slab);
  for (int t0 = t_begin; t0 < t_end; t0 += TN) {
    for (int i = threadIdx.x; i < TN * VPR; i += NTHREADS) {
      const int r = i / VPR, col = (i % VPR) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (t0 + r < t_end) raw = *reinterpret_cast<const uint4*>(xb + (size_t)(t0 + r) * D + col);
      *reinterpret_cast<uint4*>(sX + r * LD + col) = raw;
    }
    __syncthreads();

    uint32_t af[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* p = sX + (warp * 16 + g) * LD + kk * 16 + 2 * t4;
      af[kk][0] = *reinterpret_cast<const uint32_t*>(p);
      af[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
      af[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      af[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
    }
    float best[2] = {INFINITY, INFINITY};
    int arg[2] = {0, 0};
    for (int k0 = 0; k0 < k_pad; k0 += KCHUNK) {
      float sc[KCHUNK / 8][4];
#pragma unroll
      for (int nt = 0; nt < KCHUNK / 8; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const bf16* p = sC + (k0 + nt * 8 + g) * LD + kk * 16 + 2 * t4;
          mma_16816(sc[nt], af[kk], *reinterpret_cast<const uint32_t*>(p), *reinterpret_cast<const uint32_t*>(p + 8));
        }
      }
      // this thread's columns come in ascending k: a strict < keeps the first
#pragma unroll
      for (int nt = 0; nt < KCHUNK / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + nt * 8 + 2 * t4 + (j & 1);
          const float dist = __fsub_rn(sCsq[col], __fmul_rn(2.f, sc[nt][j]));
          if (col < K && dist < best[j >> 1]) {
            best[j >> 1] = dist;
            arg[j >> 1] = col;
          }
        }
      }
    }
    // merge the quad's four argmins of each row; the smaller index wins a tie
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[rr], off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg[rr], off);
        if (ob < best[rr] || (ob == best[rr] && oa < arg[rr])) {
          best[rr] = ob;
          arg[rr] = oa;
        }
      }
    }
    if (t4 == 0) {
      sLab[warp * 16 + g] = arg[0];
      sLab[warp * 16 + g + 8] = arg[1];
    }
    __syncthreads();

    const int n_tok = min(TN, t_end - t0);
    if (threadIdx.x < n_tok) {
      const int lab = sLab[threadIdx.x];
      labels[(size_t)b * N + t0 + threadIdx.x] = lab;
      atomicAdd(&sCnt[lab], 1);
    }
    for (int d = threadIdx.x; d < D; d += NTHREADS) {
      for (int r = 0; r < n_tok; ++r) {
        float* dst = sSum + (size_t)sLab[r] * D + d;
        *dst = __fadd_rn(*dst, __bfloat162float(sX[r * LD + d]));
      }
    }
    __syncthreads();  // before the next tile overwrites sX and sLab
  }

  float* ps = part_sums + ((size_t)b * n_slabs + s) * K * D;
  for (int i = threadIdx.x; i < K * D; i += NTHREADS) ps[i] = sSum[i];
  int* pc = part_counts + ((size_t)b * n_slabs + s) * K;
  for (int i = threadIdx.x; i < K; i += NTHREADS) pc[i] = sCnt[i];
}

// sums[b, k, d] = sum over slabs in slab order; counts likewise (as f32)
__global__ void kmeans_reduce_kernel(const float* __restrict__ part_sums, const int* __restrict__ part_counts,
                                     float* __restrict__ sums, float* __restrict__ counts, int B, int K, int D,
                                     int n_slabs) {
  const size_t total = (size_t)B * K * D;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += (size_t)gridDim.x * blockDim.x) {
    const size_t b = i / ((size_t)K * D);
    const size_t rem = i % ((size_t)K * D);
    float acc = 0.f;
    for (int s = 0; s < n_slabs; ++s) acc = __fadd_rn(acc, part_sums[(b * n_slabs + s) * K * D + rem]);
    sums[i] = acc;
    if (rem % D == 0) {
      const size_t kk = rem / D;
      int cnt = 0;
      for (int s = 0; s < n_slabs; ++s) cnt += part_counts[(b * n_slabs + s) * K + kk];
      counts[b * K + kk] = (float)cnt;
    }
  }
}

template <int D>
cudaError_t launch_kmeans(const void* x, const void* c, int* labels, float* part_sums, int* part_counts,
                          float* sums, float* counts, int B, int N, int K, int n_slabs, cudaStream_t stream) {
  const size_t smem = smem_bytes(K, D);
  cudaError_t err =
      cudaFuncSetAttribute(kmeans_slab_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kmeans_slab_kernel<D><<<dim3(n_slabs, B), NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(c), labels, part_sums, part_counts, N, K,
      slab_len(N, n_slabs));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)B * K * D;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  kmeans_reduce_kernel<<<blocks, threads, 0, stream>>>(part_sums, part_counts, sums, counts, B, K, D, n_slabs);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the slab kernel needs at K centroids of width D (the
// wrapper checks it against the card's limit before launching).
extern "C" int svt_kmeans_smem_bytes(int K, int D) { return (int)smem_bytes(K, D); }

// How many token slabs (CTAs per batch row) the pass uses: enough CTAs to
// give every SM one, never a slab shorter than one tile. The wrapper sizes
// the partial buffers with it.
extern "C" int svt_kmeans_num_slabs(int B, int N) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int want = (sms + B - 1) / B;
  const int tiles = (N + TN - 1) / TN;
  return want < 1 ? 1 : (want > tiles ? (tiles < 1 ? 1 : tiles) : want);
}

// x (B, N, D) bf16, c (B, K, D) bf16, labels (B, N) int32, part_sums
// (B, n_slabs, K, D) f32, part_counts (B, n_slabs, K) int32, sums (B, K, D)
// f32, counts (B, K) f32, all contiguous on the device (checked by the
// wrapper in ops/kmeans.py); D in {64, 128}.
extern "C" int svt_kmeans_assign_update(const void* x, const void* c, void* labels, void* part_sums,
                                        void* part_counts, void* sums, void* counts, int B, int N, int K, int D,
                                        int n_slabs, void* stream) {
  if (B == 0 || N == 0) return 0;
  int* l = static_cast<int*>(labels);
  float* ps = static_cast<float*>(part_sums);
  int* pc = static_cast<int*>(part_counts);
  float* su = static_cast<float*>(sums);
  float* co = static_cast<float*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch_kmeans<128>(x, c, l, ps, pc, su, co, B, N, K, n_slabs, s);
  if (D == 64) return (int)launch_kmeans<64>(x, c, l, ps, pc, su, co, B, N, K, n_slabs, s);
  return (int)cudaErrorInvalidValue;
}
