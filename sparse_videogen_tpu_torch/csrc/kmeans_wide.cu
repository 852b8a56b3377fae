// The k-means Lloyd pass at any K, bf16 tokens, f32 sums, sm_90a.
//
// Replaces the TPU kernel sparse_videogen_tpu/ops/kmeans_pallas.py::_kernel
// (entry kmeans_assign_update; both its branches, after the design of its
// wide-K branch, k_pad >= 256) and the variant probe
// scripts/probe_kmeans_variants.py::_kernel, whose variant C that branch
// ships. The TPU pads K to 128 lanes with +inf distances and N to its block;
// here the kernels bounds-check both. For x (B, N, D) and centroids c
// (B, K, D), with dist[n, k] = |c_k|^2 - 2 x_n . c_k in f32 (|x_n|^2 left
// out, as on the TPU: it cannot change the argmin):
//   A  labels = argmin_k dist, first index on a tie; sums[k] = sum of the
//      x_n labelled k (f32), counts[k] = their number
//   B  the same labels by a two-min tiebreak (min, then the first k with
//      dist <= min); sums and counts as A
//   C  B's labels; the counts as a product on the tensor cores (onehot^T 1)
//   D  no labels (all 0); a multi-hot: every k with dist <= min gets x_n
//   E  A's labels only (sums and counts stay 0)
// The wrapper (ops/kmeans.py) runs K5 at every K as one of A, B, C (the same
// labels, sums and counts) and the probe entry as any of the five.
//
// What bounds it on the H100: at Wan 2.1 14B 720p (B = 40 heads, N = 75,600,
// D = 128, K = 300 or 1000) x . c^T is 0.23-0.77 TFLOP on the tensor cores
// and x is 774 MB; the centroids (K x D bf16: 256 KB at K = 1000) no longer
// fit in shared memory beside the f32 (K, D) sums, which take 512 KB. So the
// pass is split in two kernels, and both stay deterministic (no float
// atomics: the next iteration's labels follow the centroids):
//   kernel 1 (assign), one CTA of 4 warps per (128 tokens, b): the x tile is
//     held as A-fragments (32 rows a warp, two m16 tiles) and the centroids
//     stream through shared memory in 64-row chunks, double-buffered with
//     cp.async, with their |c|^2 (a small kernel computes it first, +inf past
//     K). x . c^T is mma.sync m16n8k16 with f32 accumulation; each thread
//     folds its columns into a running state in ascending k with a strict <,
//     and the four threads of a row merge, smaller index on a tie. Writes the
//     labels (D: up to 4 tied k a token, else an overflow count).
//   kernel 2 (update), one CTA per (range of 64 clusters, token slab, b), D
//     threads: it walks the slab's labels in 256-token batches, lists the
//     tokens whose label is in its range (in token order), and thread d adds
//     column d of each listed token into the range's f32 sums in shared
//     memory, in list order, with 16 tokens' loads in flight; integer
//     counts by shared-memory atomics (exact in any order; C: the onehot^T 1
//     product on the tensor cores, exact in f32). So x is read once, not
//     once per range. It writes the slab's partial sums and counts. It is
//     latency-bound: small ranges keep 6 CTAs on an SM.
//   kernel 3 adds the slabs in slab order.
// The slab count depends only on B, N, K and the card's SM count: the same
// inputs give the same bits on every run on the same card. The distance of
// every (n, k) comes from the same mma sequence in every variant, so A, B and
// C give the same labels as each other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WT = 128;        // tokens per assign CTA (32 rows a warp)
constexpr int WTHREADS = 128;  // 4 warps
constexpr int KC = 64;         // centroid rows per streamed chunk (8 n-tiles)
constexpr int KR = 64;         // clusters per update CTA (32 KB of f32 sums at D = 128: 6 CTAs an SM)
constexpr int UB = 256;        // tokens per update batch
constexpr int UNROLL = 16;     // listed tokens whose loads are in flight at once
constexpr int TIES = 4;        // tied clusters kept per token (variant D)

enum Variant { VA = 0, VB = 1, VC = 2, VD = 3, VE = 4 };

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// csq[b, k] = |c_bk|^2 in f32, summed over d in order;
// +inf for the padding k in [K, k_pad), so padded columns never win
__global__ void kmeans_csq_kernel(const bf16* __restrict__ c, float* __restrict__ csq, int B, int K, int D,
                                  int k_pad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * k_pad) return;
  const int b = i / k_pad, k = i % k_pad;
  float acc = INFINITY;
  if (k < K) {
    acc = 0.f;
    const bf16* p = c + ((size_t)b * K + k) * D;
    for (int d = 0; d < D; ++d) {
      const float e = __bfloat162float(p[d]);
      acc = __fadd_rn(acc, __fmul_rn(e, e));
    }
  }
  csq[i] = acc;
}

size_t assign_smem_bytes(int D) {
  return (size_t)(WT + 2 * KC) * (D + 8) * sizeof(bf16) + 2 * KC * sizeof(float);
}

// labels (B, N) for A, B, C, E; for D, `labels` is (B, N, TIES): each token's
// tied clusters in ascending k, -1 after the last
template <int D, int V>
__global__ void __launch_bounds__(WTHREADS)
kmeans_wide_assign_kernel(const bf16* __restrict__ x, const bf16* __restrict__ c, const float* __restrict__ csq,
                          int* __restrict__ labels, int* __restrict__ overflow, int N, int K, int k_pad) {
  constexpr int LD = D + 8;
  constexpr int VPR = D / 8;  // 16-byte vectors a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);                 // WT x LD
  bf16* sC = sX + WT * LD;                                       // 2 x KC x LD
  float* sCsq = reinterpret_cast<float*>(sC + 2 * KC * LD);      // 2 x KC

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * WT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bf16* xb = x + (size_t)b * N * D;
  const bf16* cb = c + (size_t)b * K * D;
  const float* qb = csq + (size_t)b * k_pad;
  const int n_chunks = k_pad / KC;

  auto load_chunk = [&](int ch, int buf) {
    const int k0 = ch * KC;
    for (int i = threadIdx.x; i < KC * VPR; i += WTHREADS) {
      const int r = i / VPR, col = (i % VPR) * 8;
      const bool ok = k0 + r < K;
      cp_async16(sC + (buf * KC + r) * LD + col, cb + (size_t)(ok ? k0 + r : 0) * D + col, ok);
    }
    for (int i = threadIdx.x; i < KC / 4; i += WTHREADS) cp_async16(sCsq + buf * KC + i * 4, qb + k0 + i * 4, true);
    cp_async_commit();
  };

  load_chunk(0, 0);
  for (int i = threadIdx.x; i < WT * VPR; i += WTHREADS) {
    const int r = i / VPR, col = (i % VPR) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (t0 + r < N) raw = *reinterpret_cast<const uint4*>(xb + (size_t)(t0 + r) * D + col);
    *reinterpret_cast<uint4*>(sX + r * LD + col) = raw;
  }
  __syncthreads();
  uint32_t af[2][D / 16][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* p = sX + (warp * 32 + mt * 16 + g) * LD + kk * 16 + 2 * t4;
      af[mt][kk][0] = *reinterpret_cast<const uint32_t*>(p);
      af[mt][kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
      af[mt][kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      af[mt][kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
    }
  }

  // this thread's rows: ri = 2 * mt + h is row warp*32 + mt*16 + h*8 + g
  float best[4];
  int arg[4], cnt[4], tie[4][TIES];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    best[ri] = INFINITY;
    arg[ri] = 0;
    cnt[ri] = 0;
#pragma unroll
    for (int s = 0; s < TIES; ++s) tie[ri][s] = -1;
  }

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < n_chunks) {
      load_chunk(ch + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float sc[2][KC / 8][4];
#pragma unroll
    for (int nt = 0; nt < KC / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[0][nt][j] = sc[1][nt][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* p = sC + (buf * KC + nt * 8 + g) * LD + kk * 16 + 2 * t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 8);
        mma_16816(sc[0][nt], af[0][kk], b0, b1);
        mma_16816(sc[1][nt], af[1][kk], b0, b1);
      }
    }
    // dist = |c|^2 - 2 x.c: 2 x.c is exact, so the fma rounds as a subtraction would
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[mt][nt][j] = __fmaf_rn(-2.f, sc[mt][nt][j], sCsq[buf * KC + nt * 8 + 2 * t4 + (j & 1)]);
    const int k0 = ch * KC;

    if (V == VA || V == VE) {
      // running argmin; this thread's columns of a row come in ascending k,
      // so the strict < keeps the first
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ri = 2 * mt + (j >> 1);
            if (sc[mt][nt][j] < best[ri]) {
              best[ri] = sc[mt][nt][j];
              arg[ri] = k0 + nt * 8 + 2 * t4 + (j & 1);
            }
          }
    } else if (V == VB || V == VC) {
      // two-min over the chunk: its row minimum, then the first k that
      // reaches it; a later chunk replaces the state only if strictly smaller
      float cmin[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
      int cidx[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) cmin[2 * mt + (j >> 1)] = fminf(cmin[2 * mt + (j >> 1)], sc[mt][nt][j]);
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        cmin[ri] = fminf(cmin[ri], __shfl_xor_sync(0xffffffffu, cmin[ri], 1));
        cmin[ri] = fminf(cmin[ri], __shfl_xor_sync(0xffffffffu, cmin[ri], 2));
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ri = 2 * mt + (j >> 1);
            const int col = k0 + nt * 8 + 2 * t4 + (j & 1);
            if (sc[mt][nt][j] <= cmin[ri] && col < cidx[ri]) cidx[ri] = col;
          }
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        cidx[ri] = min(cidx[ri], __shfl_xor_sync(0xffffffffu, cidx[ri], 1));
        cidx[ri] = min(cidx[ri], __shfl_xor_sync(0xffffffffu, cidx[ri], 2));
        if (cmin[ri] < best[ri]) {
          best[ri] = cmin[ri];
          arg[ri] = cidx[ri];
        }
      }
    } else {  // VD: running minimum with the list of the k that tie it
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ri = 2 * mt + (j >> 1);
            const int col = k0 + nt * 8 + 2 * t4 + (j & 1);
            const float d = sc[mt][nt][j];
            if (d < best[ri]) {
              best[ri] = d;
              cnt[ri] = 1;
              tie[ri][0] = col;
            } else if (d == best[ri]) {
#pragma unroll
              for (int s = 1; s < TIES; ++s)
                if (cnt[ri] == s) tie[ri][s] = col;
              ++cnt[ri];
            }
          }
    }
    __syncthreads();  // the next iteration refills this buffer
  }

  if (V != VD) {
    // the quad's four states of each row: the smaller index wins a tie
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[ri], off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg[ri], off);
        if (ob < best[ri] || (ob == best[ri] && oa < arg[ri])) {
          best[ri] = ob;
          arg[ri] = oa;
        }
      }
    }
    if (t4 == 0) {
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const int r = warp * 32 + (ri >> 1) * 16 + (ri & 1) * 8 + g;
        if (t0 + r < N) labels[(size_t)b * N + t0 + r] = arg[ri];
      }
    }
    return;
  }

  // D: merge the quad's tie lists of each row in shared memory (the x tile
  // is no longer needed); one thread a row takes the tied k in ascending order
  float* mBest = reinterpret_cast<float*>(smem_raw);  // WT x 4
  int* mCnt = reinterpret_cast<int*>(mBest + WT * 4);   // WT x 4
  int* mTie = mCnt + WT * 4;                            // WT x 4 x TIES
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    const int r = warp * 32 + (ri >> 1) * 16 + (ri & 1) * 8 + g;
    mBest[r * 4 + t4] = best[ri];
    mCnt[r * 4 + t4] = cnt[ri];
#pragma unroll
    for (int s = 0; s < TIES; ++s) mTie[(r * 4 + t4) * TIES + s] = tie[ri][s];
  }
  __syncthreads();
  const int r = threadIdx.x;  // WT == WTHREADS: one row a thread
  if (t0 + r >= N) return;
  float gmin = INFINITY;
  for (int q = 0; q < 4; ++q) gmin = fminf(gmin, mBest[r * 4 + q]);
  int left[4], head[4] = {0, 0, 0, 0}, total = 0;
  for (int q = 0; q < 4; ++q) {
    const bool on = mBest[r * 4 + q] == gmin;
    left[q] = on ? min(mCnt[r * 4 + q], TIES) : 0;
    total += on ? mCnt[r * 4 + q] : 0;
  }
  int* out = labels + ((size_t)b * N + t0 + r) * TIES;
  for (int s = 0; s < TIES; ++s) {
    int pick = -1, v = INT_MAX;
    for (int q = 0; q < 4; ++q) {
      if (head[q] < left[q] && mTie[(r * 4 + q) * TIES + head[q]] < v) {
        v = mTie[(r * 4 + q) * TIES + head[q]];
        pick = q;
      }
    }
    out[s] = pick < 0 ? -1 : v;
    if (pick >= 0) ++head[pick];
  }
  if (total > TIES) atomicAdd(overflow, 1);
}

template <int D, int S>
size_t update_smem_bytes() {
  return (size_t)KR * D * sizeof(float) + (KR + UB * S + UB + D / 32) * sizeof(int);
}

// part_sums (B, n_slabs, K, D), part_counts (B, n_slabs, K); labels (B, N, S)
template <int D, int S, bool MMA_COUNTS>
__global__ void __launch_bounds__(D)
kmeans_wide_update_kernel(const bf16* __restrict__ x, const int* __restrict__ labels, float* __restrict__ part_sums,
                          int* __restrict__ part_counts, int N, int K, int slab) {
  constexpr int NW = D / 32;
  constexpr int MTW = KR / 16 / NW;  // count m-tiles a warp (MMA_COUNTS)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sSum = reinterpret_cast<float*>(smem_raw);   // KR x D
  int* sCnt = reinterpret_cast<int*>(sSum + KR * D);  // KR
  int* sList = sCnt + KR;                             // UB * S: token * KR + cluster - k0
  int* sLab = sList + UB * S;                         // UB: the batch's labels (MMA_COUNTS)
  int* sWarp = sLab + UB;                             // NW

  const int k0 = blockIdx.x * KR;
  const int kr = min(KR, K - k0);
  const int s = blockIdx.y;
  const int n_slabs = gridDim.y;
  const int b = blockIdx.z;
  const int d = threadIdx.x;
  const int warp = d >> 5;
  const int lane = d & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int* lb = labels + (size_t)b * N * S;
  const bf16* xb = x + (size_t)b * N * D;

  for (int i = d; i < KR * D; i += D) sSum[i] = 0.f;
  for (int i = d; i < KR; i += D) sCnt[i] = 0;
  float cacc[MTW][4];
#pragma unroll
  for (int m = 0; m < MTW; ++m) cacc[m][0] = cacc[m][1] = cacc[m][2] = cacc[m][3] = 0.f;
  __syncthreads();

  const int t_begin = s * slab;
  const int t_end = min(N, t_begin + slab);
  for (int tb = t_begin; tb < t_end; tb += UB) {
    const int nt = min(UB, t_end - tb);
    // list this batch's (token, slot) entries labelled in [k0, k0 + kr), in order
    int n_list = 0;
    for (int e0 = 0; e0 < UB * S; e0 += D) {
      const int e = e0 + d;
      int item = -1;
      if (e < nt * S) {
        const int lab = lb[(size_t)tb * S + e];
        if (lab >= k0 && lab < k0 + kr) {
          item = (e / S) * KR + (lab - k0);
          if (!MMA_COUNTS) atomicAdd(&sCnt[lab - k0], 1);
        }
      }
      const unsigned bal = __ballot_sync(0xffffffffu, item >= 0);
      if (lane == 0) sWarp[warp] = __popc(bal);
      __syncthreads();
      int off = n_list, tot = 0;
      for (int w = 0; w < NW; ++w) {
        off += w < warp ? sWarp[w] : 0;
        tot += sWarp[w];
      }
      if (item >= 0) sList[off + __popc(bal & ((1u << lane) - 1u))] = item;
      n_list += tot;
      __syncthreads();  // sWarp is rewritten by the next round
    }
    if (MMA_COUNTS) {
      for (int i = d; i < UB; i += D) sLab[i] = i < nt ? lb[tb + i] : -1;
      __syncthreads();
    }
    // thread d adds column d of each listed token, in list order; the loads
    // of UNROLL tokens are issued before their adds
    for (int j = 0; j < n_list; j += UNROLL) {
      int it[UNROLL];
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        it[u] = j + u < n_list ? sList[j + u] : 0;
        v[u] = j + u < n_list ? __bfloat162float(xb[(size_t)(tb + it[u] / KR) * D + d]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (j + u < n_list) {
          float* p = sSum + (it[u] % KR) * D + d;
          *p = __fadd_rn(*p, v[u]);
        }
      }
    }
    if (MMA_COUNTS) {
      // counts += onehot^T 1 on the tensor cores: A is the (16 clusters x 16
      // tokens) one-hot in bf16, B all ones; exact in f32 below 2^24
      constexpr uint32_t ONES = 0x3F803F80u;
#pragma unroll
      for (int m = 0; m < MTW; ++m) {
        const int cb = k0 + (warp * MTW + m) * 16;
        for (int ks = 0; ks < UB / 16; ++ks) {
          const int tk = ks * 16 + 2 * t4;
          auto hot = [&](int row, int t) -> uint32_t { return sLab[t] == cb + row ? 0x3F80u : 0u; };
          const uint32_t a[4] = {hot(g, tk) | (hot(g, tk + 1) << 16), hot(g + 8, tk) | (hot(g + 8, tk + 1) << 16),
                                 hot(g, tk + 8) | (hot(g, tk + 9) << 16),
                                 hot(g + 8, tk + 8) | (hot(g + 8, tk + 9) << 16)};
          mma_16816(cacc[m], a, ONES, ONES);
        }
      }
    }
    __syncthreads();  // the next batch rewrites sList and sLab
  }

  float* ps = part_sums + ((size_t)b * n_slabs + s) * K * D + (size_t)k0 * D;
  for (int lk = 0; lk < kr; ++lk) ps[lk * D + d] = sSum[lk * D + d];
  int* pc = part_counts + ((size_t)b * n_slabs + s) * K + k0;
  if (!MMA_COUNTS) {
    for (int lk = d; lk < kr; lk += D) pc[lk] = sCnt[lk];
  } else if (t4 == 0) {
#pragma unroll
    for (int m = 0; m < MTW; ++m) {
      const int lk = (warp * MTW + m) * 16 + g;
      if (lk < kr) pc[lk] = (int)cacc[m][0];
      if (lk + 8 < kr) pc[lk + 8] = (int)cacc[m][2];
    }
  }
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

cudaError_t launch_reduce(const float* part_sums, const int* part_counts, float* sums, float* counts, int B, int K,
                          int D, int n_slabs, cudaStream_t stream) {
  const size_t total = (size_t)B * K * D;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  kmeans_reduce_kernel<<<blocks, threads, 0, stream>>>(part_sums, part_counts, sums, counts, B, K, D, n_slabs);
  return cudaGetLastError();
}

int num_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int wide_slab_len(int N, int n_slabs) { return round_up((N + n_slabs - 1) / n_slabs, UB); }

template <int D, int S, bool MMA_COUNTS>
cudaError_t launch_update(const bf16* x, const int* labels, float* part_sums, int* part_counts, int B, int N, int K,
                          int n_slabs, cudaStream_t stream) {
  const size_t smem = update_smem_bytes<D, S>();
  cudaError_t err = allow_smem(kmeans_wide_update_kernel<D, S, MMA_COUNTS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((K + KR - 1) / KR, n_slabs, B);
  kmeans_wide_update_kernel<D, S, MMA_COUNTS><<<grid, D, smem, stream>>>(x, labels, part_sums, part_counts, N, K,
                                                                        wide_slab_len(N, n_slabs));
  return cudaGetLastError();
}

template <int D, int V>
cudaError_t launch_wide(const bf16* x, const bf16* c, float* csq, int* labels, int* overflow, float* part_sums,
                        int* part_counts, float* sums, float* counts, int B, int N, int K, int n_slabs,
                        cudaStream_t stream) {
  const int k_pad = round_up(K, KC);
  const int total = B * k_pad;
  kmeans_csq_kernel<<<(total + 255) / 256, 256, 0, stream>>>(c, csq, B, K, D, k_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = assign_smem_bytes(D);
  err = allow_smem(kmeans_wide_assign_kernel<D, V>, smem);
  if (err != cudaSuccess) return err;
  kmeans_wide_assign_kernel<D, V><<<dim3((N + WT - 1) / WT, B), WTHREADS, smem, stream>>>(x, c, csq, labels, overflow,
                                                                                          N, K, k_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess || V == VE) return err;
  constexpr int S = V == VD ? TIES : 1;
  err = launch_update<D, S, V == VC>(x, labels, part_sums, part_counts, B, N, K, n_slabs, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(part_sums, part_counts, sums, counts, B, K, D, n_slabs, stream);
}

template <int D>
cudaError_t dispatch_variant(int variant, const bf16* x, const bf16* c, float* csq, int* labels, int* overflow,
                             float* ps, int* pc, float* su, float* co, int B, int N, int K, int n_slabs,
                             cudaStream_t s) {
  switch (variant) {
    case VA: return launch_wide<D, VA>(x, c, csq, labels, overflow, ps, pc, su, co, B, N, K, n_slabs, s);
    case VB: return launch_wide<D, VB>(x, c, csq, labels, overflow, ps, pc, su, co, B, N, K, n_slabs, s);
    case VC: return launch_wide<D, VC>(x, c, csq, labels, overflow, ps, pc, su, co, B, N, K, n_slabs, s);
    case VD: return launch_wide<D, VD>(x, c, csq, labels, overflow, ps, pc, su, co, B, N, K, n_slabs, s);
    case VE: return launch_wide<D, VE>(x, c, csq, labels, overflow, ps, pc, su, co, B, N, K, n_slabs, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Token slabs of the update kernel: about eight CTAs an SM over the (cluster
// range, slab, b) grid, never a slab shorter than one batch. The wrapper
// sizes the partial buffers with it.
extern "C" int svt_kmeans_wide_num_slabs(int B, int N, int K) {
  const int ranges = (K + KR - 1) / KR;
  const int want = (8 * num_sms() + B * ranges - 1) / (B * ranges);
  const int batches = (N + UB - 1) / UB;
  return want < 1 ? 1 : (want > batches ? (batches < 1 ? 1 : batches) : want);
}

// x (B, N, D) bf16, c (B, K, D) bf16, csq (B, round_up(K, 64)) f32 scratch,
// labels (B, N) int32 (variant D: (B, N, 4)), overflow (1,) int32 zeroed
// (D: tokens with more than 4 tied clusters), part_sums (B, n_slabs, K, D)
// f32, part_counts (B, n_slabs, K) int32, sums (B, K, D) f32, counts (B, K)
// f32, all contiguous on the device and 16-byte aligned (checked by the
// wrapper in ops/kmeans.py); D in {64, 128}; variant 0-4 = A-E (E writes
// only the labels, and takes null partial/sum/count pointers).
extern "C" int svt_kmeans_wide(const void* x, const void* c, void* csq, void* labels, void* overflow, void* part_sums,
                               void* part_counts, void* sums, void* counts, int B, int N, int K, int D, int variant,
                               int n_slabs, void* stream) {
  if (B == 0 || N == 0) return 0;
  const bf16* xx = static_cast<const bf16*>(x);
  const bf16* cc = static_cast<const bf16*>(c);
  float* q = static_cast<float*>(csq);
  int* l = static_cast<int*>(labels);
  int* o = static_cast<int*>(overflow);
  float* ps = static_cast<float*>(part_sums);
  int* pc = static_cast<int*>(part_counts);
  float* su = static_cast<float*>(sums);
  float* co = static_cast<float*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)dispatch_variant<128>(variant, xx, cc, q, l, o, ps, pc, su, co, B, N, K, n_slabs, s);
  if (D == 64) return (int)dispatch_variant<64>(variant, xx, cc, q, l, o, ps, pc, su, co, B, N, K, n_slabs, s);
  return (int)cudaErrorInvalidValue;
}
