// The k-means Lloyd pass at any K, bf16 tokens, f32 sums, sm_90a (K5).
//
// Replaces the TPU kernel sparse_videogen_tpu/ops/kmeans_pallas.py::_kernel
// (entry kmeans_assign_update). For x (B, N, D) and centroids c (B, K, D),
// with dist[n, k] = |c_k|^2 - 2 x_n . c_k in f32 (|x_n|^2 left out, as on
// the TPU: it cannot change the argmin):
//   labels[n] = argmin_k dist, the first index on a tie;
//   sums[k]   = the f32 sum of the x_n labelled k, counts[k] their number.
// The TPU pads K to 128 lanes with +inf distances and N to its block; here
// the tiles past K get |c|^2 = +inf and the tokens past N are not written.
//
// What bounds it on the H100: at Wan 2.1 14B 720p (B = 40 heads, N =
// 75,600, D = 128, K = 1000) x . c^T is 0.77 TFLOP on the tensor cores
// (0.78 ms) and x is 774 MB (0.23 ms). The first design streamed all K
// centroids through every 128-token CTA with cp.async and mma.sync, and its
// update walked every slab's labels once per 64-cluster range. This one:
//   0. |c|^2 (kmeans_csq_kernel), a warp a centroid, +inf past K.
//   1. assign (kmeans_assign_kernel), K1's pattern (csrc/hopper_attn.cuh):
//      a persistent CTA an SM walks items of XT = 256 tokens; its producer
//      thread loads an item's token tile by TMA into one of two buffers (the
//      next item's tile loads while this one computes) and streams the
//      item's 128-centroid tiles, each with its |c|^2, through a ring of TMA
//      stages; two consumer warpgroups of 128 tokens (two 64-row wgmma tiles
//      each) compute x . c^T with wgmma m64n128k16 and, in place of the
//      softmax, a running row argmin: dist = |c|^2 - 2 x.c (one FMA: 2 x.c
//      is exact), ascending k, strict <; the four threads of a row merge,
//      the smaller index on a tie. 256 tokens share each centroid tile: half
//      the L2 traffic of a 128-token tile. It also counts its tokens' labels
//      into the histogram of their CH-token chunk (integer atomics: the same
//      counts in any order).
//   2. scan (kmeans_scan_kernel), a CTA per b: each cluster's count and the
//      start of each (chunk, cluster) in the order sorted by (label,
//      token); the counts; each cluster's segments of at most SEG tokens.
//   3. scatter (kmeans_scatter_kernel), a warp per (b, chunk): token ids
//      into that order, 32 at a time in token order (__match_any_sync ranks
//      the equal labels of a step): a stable counting sort.
//   4. segment sums (kmeans_segsum_kernel), a warp per segment: the f32 sum
//      of its tokens' rows in token order, each lane its D / 32 columns;
//      every row of x is read once.
//   5. combine (kmeans_combine_kernel), a warp per (b, cluster): its
//      segments' partial sums in segment order.
// No float atomics: the same inputs give the same bits on every run (the
// reference's sorted segment sum, as the TPU kernel's docstring names it).
//
// K8, the probe's five variants of the pass (scripts/probe_kmeans_variants.py
// ::_kernel, entry run), run on this pipeline with the variant as a template
// parameter of the assign; A is this pass itself:
//   A  the running argmin above
//   B  per 128-centroid tile a two-min (the tile's row minimum, then the
//      first k at or below it), merged across tiles by a strict <: the
//      same labels as A
//   C  B's labels; the counts taken from the tensor cores
//      (kmeans_count_kernel: the one-hot of the labels against a ones
//      operand, mma.sync, exact in f32) instead of the histogram
//   D  no labels: a multi-hot. The assign keeps up to TIES tied k a token
//      (dist == the row's minimum; more count into `overflow`), labels (B,
//      N, TIES) padded with -1, and the update sorts and sums every (token,
//      tied k) entry
//   E  the assign's labels alone; sums and counts 0

#include <limits.h>
#include <math.h>

#include <type_traits>

#include "hopper_attn.cuh"

namespace {

constexpr int XT = 256;    // tokens an item of the assign kernel
constexpr int CT = 128;    // centroids a tile
constexpr int CH = 1024;   // tokens a chunk of the counting sort (a multiple of XT)
constexpr int SEG = 128;   // tokens at most a segment of the sums
constexpr int SCAN_THREADS = 1024;
constexpr int WARPS = 4;   // warps a CTA of the |c|^2, scatter, segment-sum and combine kernels
constexpr int INFLIGHT = 16;  // rows a segment-sum warp loads before it adds them
constexpr int TIES = 4;       // tied clusters variant D keeps a token (ops/kmeans.py D_TIES)
constexpr int COUNT_WARPS = 8;  // warps of a kmeans_count_kernel CTA, each a share of the tokens

enum Variant { VA = 0, VB = 1, VC = 2, VD = 3, VE = 4 };

template <int D>
struct AssignLayout {
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int X_BYTES = XT * D * 2;  // a token tile; two buffers
  static constexpr int C_BYTES = CT * D * 2;  // a centroid tile
  static constexpr int CSQ_BYTES = CT * 4;    // its |c|^2
  static constexpr int C_OFF = 2 * X_BYTES;
  static constexpr int CSQ_OFF = C_OFF + STAGES * C_BYTES;
  static constexpr int BAR_OFF = CSQ_OFF + STAGES * CSQ_BYTES;
  // barriers: full, empty (per stage), x full, x empty (per buffer); 1024 bytes to align the base
  static constexpr int USED = BAR_OFF + (2 * STAGES + 4) * 8 + 1024;
  // more than half an SM's shared memory, so one CTA an SM (setmaxnreg)
  static constexpr int SMEM = USED > 232448 / 2 ? USED : 232448 / 2 + 1024;
  static_assert(USED <= 232448, "shared memory layout");
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// the scratch regions of one pass, carved from one workspace
struct Work {
  float* csq;      // (B, k_pad): |c|^2, +inf past K
  int* hist;       // (B, n_ch, K): a chunk's label counts, then its start in the sorted order
  int* offs;       // (B, K): a cluster's first position in the sorted order
  int* seg_start;  // (B, K + 1): a cluster's first segment; [K] the number of segments
  int* perm;       // (B, N * slots): token ids sorted by (label, token)
  float* partial;  // (B, max_segs, D): the segments' sums
  int k_pad, n_ch, max_segs;
};

size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

// `slots` sorted entries a token: 1, or TIES for variant D
size_t carve(void* base, int B, int N, int K, int D, int slots, Work* w) {
  const int k_pad = cdiv(K, CT) * CT, n_ch = cdiv(N, CH), max_segs = cdiv(N * slots, SEG) + K;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base == nullptr ? nullptr : static_cast<char*>(base) + off;
    off += align256(bytes);
    return p;
  };
  float* csq = (float*)take((size_t)B * k_pad * 4);
  int* hist = (int*)take((size_t)B * n_ch * K * 4);
  int* offs = (int*)take((size_t)B * K * 4);
  int* seg = (int*)take((size_t)B * (K + 1) * 4);
  int* perm = (int*)take((size_t)B * N * slots * 4);
  float* partial = (float*)take((size_t)B * max_segs * D * 4);
  if (w != nullptr) *w = {csq, hist, offs, seg, perm, partial, k_pad, n_ch, max_segs};
  return off;
}

// a bulk copy of `bytes` (a multiple of 16) from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// csq[b, k] = |c_bk|^2 in f32, a warp a centroid: each lane its D / 32
// columns in order, then a fixed butterfly; +inf for k in [K, k_pad)
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
kmeans_csq_kernel(const bf16* __restrict__ c, float* __restrict__ csq, int B, int K, int k_pad) {
  constexpr int C = D / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= B * k_pad) return;
  const int b = row / k_pad, k = row % k_pad;
  float acc = 0.f;
  if (k < K) {
    const bf16* p = c + ((size_t)b * K + k) * D + lane * C;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const float f = __bfloat162float(p[q]);
      acc = __fadd_rn(acc, __fmul_rn(f, f));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if (lane == 0) csq[row] = k < K ? acc : INFINITY;
}

// A persistent CTA an SM walks the items (b, 256-token tile) blockIdx.x,
// + gridDim.x, ...: its producer loads an item's token tile into one of two
// buffers (the next item's loads while this one computes) and streams the
// item's centroid tiles, each with its |c|^2, through the ring. labels (B,
// N), with V == VD (B, N, TIES); hist (B, n_ch, K) zeroed: += one per token
// and label (V == VE: not touched); overflow (V == VD): += one per token
// with more than TIES tied k. V is VA, VB, VD or VE (C runs VB).
template <int D, int V>
__global__ void __launch_bounds__(NTHREADS, 1)
kmeans_assign_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_c,
                     const float* __restrict__ csq_g, int* __restrict__ labels, int* __restrict__ hist,
                     int* __restrict__ overflow, int B, int N, int K, int k_pad, int n_ch) {
  using LY = AssignLayout<D>;
  constexpr int STAGES = LY::STAGES;
  const int tiles = cdiv(N, XT), n_items = B * tiles;
  const int n_ct = k_pad / CT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar = base + LY::BAR_OFF;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };
  auto x_full = [&](int i) { return bar + 8 * (2 * STAGES + i); };
  auto x_empty = [&](int i) { return bar + 8 * (2 * STAGES + 2 + i); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(x_full(i), 1);
      mbar_init(x_empty(i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int stage = 0, xb = 0;
      uint32_t phase = 0, xphase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int b = item / tiles, t0 = (item % tiles) * XT;
        const uint32_t xs = base + xb * LY::X_BYTES;
        mbar_wait(x_empty(xb), xphase ^ 1);
        mbar_expect_tx(x_full(xb), LY::X_BYTES);
#pragma unroll
        for (int rb = 0; rb < XT / 128; ++rb)
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb)
            tma_load(xs + cb * XT * ROW_BYTES + rb * 128 * ROW_BYTES, &tm_x, x_full(xb), cb * 64, b * N + t0 + rb * 128);
        for (int j = 0; j < n_ct; ++j) {
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t cs = base + LY::C_OFF + stage * LY::C_BYTES;
          mbar_expect_tx(full(stage), LY::C_BYTES + LY::CSQ_BYTES);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb)
            tma_load(cs + cb * CT * ROW_BYTES, &tm_c, full(stage), cb * 64, b * K + j * CT);
          bulk_load(base + LY::CSQ_OFF + stage * LY::CSQ_BYTES, csq_g + (size_t)b * k_pad + j * CT, LY::CSQ_BYTES,
                    full(stage));
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        if (++xb == 2) {
          xb = 0;
          xphase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroups: 128 tokens of an item each, as two 64-row wgmma tiles
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    int stage = 0, xb = 0;
    uint32_t phase = 0, xphase = 0;
    float a0[64], a1[64];
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int b = item / tiles, t0 = (item % tiles) * XT;
      const uint32_t xa = base + xb * LY::X_BYTES + wg * 128 * ROW_BYTES;  // this warpgroup's first row
      // row r = 2 * tile + half of this thread: best distance, its k (D:
      // the count and the first TIES k at it, ascending)
      float best[4];
      int arg[4], cnt[4], tie[4][TIES];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        best[r] = INFINITY;
        arg[r] = 0;
        cnt[r] = 0;
#pragma unroll
        for (int e = 0; e < TIES; ++e) tie[r][e] = -1;
      }
      mbar_wait(x_full(xb), xphase);
      for (int j = 0; j < n_ct; ++j) {
        const int k0 = j * CT;
        const uint32_t cs = base + LY::C_OFF + stage * LY::C_BYTES;
        mbar_wait(full(stage), phase);
        // S = x . c^T for both 64-row tiles (K-major operands, 128B swizzle)
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          const uint64_t db = sw128_desc(cs + (kk / 4) * CT * ROW_BYTES + col, 16, 8 * ROW_BYTES);
          wgmma_ss_n128(a0, sw128_desc(xa + (kk / 4) * XT * ROW_BYTES + col, 16, 8 * ROW_BYTES), db, kk > 0);
          wgmma_ss_n128(a1, sw128_desc(xa + (kk / 4) * XT * ROW_BYTES + 64 * ROW_BYTES + col, 16, 8 * ROW_BYTES), db,
                        kk > 0);
        }
        wg_commit();
        wg_wait0();
        reg_fence(a0);
        reg_fence(a1);
        // dist = |c|^2 - 2 x.c (2 x.c is exact, so the FMA rounds as a
        // subtraction would); this thread's columns of a row come in
        // ascending k, so the strict < keeps the first
        const float* csq = reinterpret_cast<const float*>(gbase + LY::CSQ_OFF + stage * LY::CSQ_BYTES);
        if constexpr (V == VB || V == VD) {
          // the distances replace the products in place; this thread's
          // minimum of each row over the tile
          float tmin[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const float q = csq[8 * (i / 4) + 2 * t4 + (i & 1)];
            const int r = (i & 2) >> 1;
            a0[i] = __fmaf_rn(-2.f, a0[i], q);
            a1[i] = __fmaf_rn(-2.f, a1[i], q);
            tmin[r] = fminf(tmin[r], a0[i]);
            tmin[2 + r] = fminf(tmin[2 + r], a1[i]);
          }
          if constexpr (V == VB) {
            // B: the tile's row minimum, then the first k at or below it (the
            // quad merges both); a tile replaces the state only if strictly smaller
            int tidx[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              tmin[r] = fminf(tmin[r], __shfl_xor_sync(0xffffffffu, tmin[r], 1));
              tmin[r] = fminf(tmin[r], __shfl_xor_sync(0xffffffffu, tmin[r], 2));
            }
#pragma unroll
            for (int i = 0; i < 64; ++i) {
              const int c = 8 * (i / 4) + 2 * t4 + (i & 1);
              const int r = (i & 2) >> 1;
              if (a0[i] <= tmin[r] && k0 + c < tidx[r]) tidx[r] = k0 + c;
              if (a1[i] <= tmin[2 + r] && k0 + c < tidx[2 + r]) tidx[2 + r] = k0 + c;
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              tidx[r] = min(tidx[r], __shfl_xor_sync(0xffffffffu, tidx[r], 1));
              tidx[r] = min(tidx[r], __shfl_xor_sync(0xffffffffu, tidx[r], 2));
              if (tmin[r] < best[r]) {
                best[r] = tmin[r];
                arg[r] = tidx[r];
              }
            }
          } else {
            // D: a running minimum with the k that tie it, ascending (a
            // smaller minimum restarts the list; entries past cnt are stale)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              if (tmin[r] < best[r]) {
                best[r] = tmin[r];
                cnt[r] = 0;
              }
            }
            auto add = [&](int r, int k) {
#pragma unroll
              for (int e = 0; e < TIES; ++e)
                if (cnt[r] == e) tie[r][e] = k;
              ++cnt[r];
            };
#pragma unroll
            for (int i = 0; i < 64; ++i) {
              const int c = 8 * (i / 4) + 2 * t4 + (i & 1);
              const int r = (i & 2) >> 1;
              if (a0[i] == best[r]) add(r, k0 + c);
              if (a1[i] == best[2 + r]) add(2 + r, k0 + c);
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int c = 8 * (i / 4) + 2 * t4 + (i & 1);
            const float q = csq[c];
            const int r = (i & 2) >> 1;
            const float d0 = __fmaf_rn(-2.f, a0[i], q), d1 = __fmaf_rn(-2.f, a1[i], q);
            if (d0 < best[r]) {
              best[r] = d0;
              arg[r] = k0 + c;
            }
            if (d1 < best[2 + r]) {
              best[2 + r] = d1;
              arg[2 + r] = k0 + c;
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(stage));
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      // the token tile is no longer read (the last wgmma has completed)
      if (lane == 0) mbar_arrive(x_empty(xb));
      if (++xb == 2) {
        xb = 0;
        xphase ^= 1;
      }
      int* h = hist + ((size_t)b * n_ch + t0 / CH) * K;
      if constexpr (V == VD) {
        // the quad's tie lists of each row: the k of the threads at the
        // row's minimum, the TIES smallest in ascending order (each k is in
        // one thread's list)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float gmin = fminf(best[r], __shfl_xor_sync(0xffffffffu, best[r], 1));
          gmin = fminf(gmin, __shfl_xor_sync(0xffffffffu, gmin, 2));
          const int mine = best[r] == gmin ? cnt[r] : 0;
          int total = mine + __shfl_xor_sync(0xffffffffu, mine, 1);
          total += __shfl_xor_sync(0xffffffffu, total, 2);
          int len[4], lists[4][TIES];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            len[q] = min(__shfl_sync(0xffffffffu, mine, (lane & ~3) + q), TIES);
#pragma unroll
            for (int e = 0; e < TIES; ++e) lists[q][e] = __shfl_sync(0xffffffffu, tie[r][e], (lane & ~3) + q);
          }
          const int t = t0 + wg * 128 + (r >> 1) * 64 + warp * 16 + (r & 1) * 8 + g;
          if (t4 == 0 && t < N) {
            int* out = labels + ((size_t)b * N + t) * TIES;
            int last = -1;
#pragma unroll
            for (int e = 0; e < TIES; ++e) {
              int v = INT_MAX;
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int u = 0; u < TIES; ++u)
                  if (u < len[q] && lists[q][u] > last && lists[q][u] < v) v = lists[q][u];
              out[e] = v == INT_MAX ? -1 : v;
              if (v != INT_MAX) atomicAdd(h + v, 1);
              last = v;
            }
            if (total > TIES) atomicAdd(overflow, 1);
          }
        }
      } else {
        // the quad's four states of each row: the smaller index wins a tie
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {
            const float ob = __shfl_xor_sync(0xffffffffu, best[r], off);
            const int oa = __shfl_xor_sync(0xffffffffu, arg[r], off);
            if (ob < best[r] || (ob == best[r] && oa < arg[r])) {
              best[r] = ob;
              arg[r] = oa;
            }
          }
        }
        if (t4 == 0) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            // r = 2 * tile + half: row wg * 128 + tile * 64 + warp * 16 + half * 8 + g
            const int t = t0 + wg * 128 + (r >> 1) * 64 + warp * 16 + (r & 1) * 8 + g;
            if (t < N) {
              labels[(size_t)b * N + t] = arg[r];
              if (V != VE) atomicAdd(h + arg[r], 1);
            }
          }
        }
      }
    }
  }
}

// exclusive prefix sum over the CTA's threads (blockDim.x == SCAN_THREADS) of
// v; *total gets the sum of all
__device__ __forceinline__ int block_exclusive_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < SCAN_THREADS / 32 ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    sh[32 + lane] = s;  // inclusive sums of the warps
  }
  __syncthreads();
  const int before = (w > 0 ? sh[32 + w - 1] : 0) + x - v;
  *total = sh[32 + SCAN_THREADS / 32 - 1];
  __syncthreads();  // sh is reused by the next call
  return before;
}

// a CTA per b: hist (counts per chunk) -> each (chunk, cluster)'s start in the
// sorted order; offs, counts (f32) and the segments of each cluster
__global__ void __launch_bounds__(SCAN_THREADS)
kmeans_scan_kernel(int* __restrict__ hist, int* __restrict__ offs, int* __restrict__ seg_start,
                   float* __restrict__ counts, int K, int n_ch) {
  __shared__ int sh[64];
  const int b = blockIdx.x;
  int* h = hist + (size_t)b * n_ch * K;
  int carry = 0, seg_carry = 0;
  for (int k0 = 0; k0 < K; k0 += SCAN_THREADS) {
    const int k = k0 + threadIdx.x;
    int total = 0;
    if (k < K)
      for (int c = 0; c < n_ch; ++c) total += h[(size_t)c * K + k];
    const int nseg = (total + SEG - 1) / SEG;
    int sum_all, seg_all;
    const int off = carry + block_exclusive_scan(total, sh, &sum_all);
    const int sg = seg_carry + block_exclusive_scan(nseg, sh, &seg_all);
    if (k < K) {
      int run = off;
      for (int c = 0; c < n_ch; ++c) {
        const int n = h[(size_t)c * K + k];
        h[(size_t)c * K + k] = run;
        run += n;
      }
      offs[(size_t)b * K + k] = off;
      seg_start[(size_t)b * (K + 1) + k] = sg;
      counts[(size_t)b * K + k] = (float)total;
    }
    carry += sum_all;
    seg_carry += seg_all;
  }
  if (threadIdx.x == 0) seg_start[(size_t)b * (K + 1) + K] = seg_carry;
}

// a warp per (b, chunk): perm[b, start of label + rank] = token, in token
// order (a stable counting sort), the chunk's labels loaded first;
// dynamic shared memory WARPS * K ints. S > 1 (variant D): labels (B, N, S),
// -1 where a token has no more tied k; each (token, slot) entry is placed,
// 32 tokens at a time and slot by slot within them (a fixed order)
template <int S>
__global__ void __launch_bounds__(WARPS * 32)
kmeans_scatter_kernel(const int* __restrict__ labels, const int* __restrict__ hist, int* __restrict__ perm, int B,
                      int N, int K, int n_ch) {
  extern __shared__ int cursor_all[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int item = blockIdx.x * WARPS + w;
  if (item >= B * n_ch) return;
  const int b = item / n_ch, c = item % n_ch;
  const int t_begin = c * CH, end = min(N, t_begin + CH);
  const int* lb = labels + (size_t)b * N * S;
  int lab[S == 1 ? CH / 32 : 1];
  if constexpr (S == 1) {
#pragma unroll
    for (int u = 0; u < CH / 32; ++u) {
      const int tok = t_begin + u * 32 + lane;
      lab[u] = tok < end ? lb[tok] : -1 - lane;  // invalid lanes match nobody
    }
  }
  int* cur = cursor_all + w * K;
  for (int k = lane; k < K; k += 32) cur[k] = hist[(size_t)item * K + k];
  __syncwarp();
  int* pb = perm + (size_t)b * N * S;
  // place one entry a lane (label l; l < 0 places nothing) of tokens tok
  auto place = [&](int tok, int l) {
    const bool valid = tok < end && l >= 0;
    const unsigned peers = __match_any_sync(0xffffffffu, l);
    if (valid) pb[cur[l] + __popc(peers & ((1u << lane) - 1u))] = tok;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) cur[l] += __popc(peers);
    __syncwarp();
  };
  if constexpr (S == 1) {
#pragma unroll
    for (int u = 0; u < CH / 32; ++u) place(t_begin + u * 32 + lane, lab[u]);
  } else {
    constexpr int AHEAD = 8;  // tokens a lane whose labels load before their placements
    for (int u0 = 0; u0 < CH / 32; u0 += AHEAD) {
      int l[AHEAD][S];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int tok = t_begin + (u0 + u) * 32 + lane;
#pragma unroll
        for (int e = 0; e < S; ++e) l[u][e] = tok < end ? lb[(size_t)tok * S + e] : -1 - lane;
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u)
#pragma unroll
        for (int e = 0; e < S; ++e) place(t_begin + (u0 + u) * 32 + lane, l[u][e]);
    }
  }
}

// Variant C's counts on the tensor cores: a CTA per (b, 16 clusters), warp
// w a share of the tokens in 16-token steps; mma.sync m16n8k16 of the
// one-hot (16 clusters x 16 tokens, from the labels) against ones, f32
// (exact: integers below 2^24); the warps' partial counts added in warp
// order. counts[b, k] (f32) for k < K.
__global__ void __launch_bounds__(COUNT_WARPS * 32)
kmeans_count_kernel(const int* __restrict__ labels, float* __restrict__ counts, int N, int K) {
  __shared__ float part[COUNT_WARPS][16];
  const int kt = cdiv(K, 16);
  const int b = blockIdx.x / kt, k0 = (blockIdx.x % kt) * 16;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int* lb = labels + (size_t)b * N;
  const int steps = cdiv(N, 16), per = cdiv(steps, COUNT_WARPS);
  constexpr uint32_t ONE = 0x3F80u, ONES = 0x3F803F80u;  // bf16 1.0, two of them
  constexpr int AHEAD = 8;  // steps whose labels load before their products
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int end = min(steps, (w + 1) * per);
  for (int st0 = w * per; st0 < end; st0 += AHEAD) {
    int l[AHEAD][4];  // tokens t, t + 1, t + 8, t + 9 of each step (t = 16 step + 2 t4); -1 past N
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int t = (st0 + u) * 16 + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = t + (e & 1) + 8 * (e >> 1);
        l[u][e] = st0 + u < end && tok < N ? lb[tok] : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      auto hot = [&](int e, int row) { return l[u][e] == k0 + row ? ONE : 0u; };
      const uint32_t a[4] = {hot(0, g) | (hot(1, g) << 16), hot(0, g + 8) | (hot(1, g + 8) << 16),
                             hot(2, g) | (hot(3, g) << 16), hot(2, g + 8) | (hot(3, g + 8) << 16)};
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(ONES), "r"(ONES));
    }
  }
  // every column of a row holds its cluster's count: rows g (acc[0]) and g + 8 (acc[2])
  if (t4 == 0) {
    part[w][g] = acc[0];
    part[w][g + 8] = acc[2];
  }
  __syncthreads();
  if (threadIdx.x < 16 && k0 + threadIdx.x < K) {
    float total = 0.f;
    for (int i = 0; i < COUNT_WARPS; ++i) total += part[i][threadIdx.x];
    counts[(size_t)b * K + k0 + threadIdx.x] = total;
  }
}

// a warp per segment s of b: partial[b, s] = the f32 sum, in sorted order, of
// the x rows of its entries (perm holds `slots` entries a token); lane l
// holds columns [l * D / 32, (l + 1) * D / 32)
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
kmeans_segsum_kernel(const bf16* __restrict__ x, const int* __restrict__ perm, const int* __restrict__ offs,
                     const int* __restrict__ seg_start, const float* __restrict__ counts, float* __restrict__ partial,
                     int B, int N, int K, int max_segs, int slots) {
  constexpr int C = D / 32;  // columns a lane: 4 (8 bytes) or 2 (4 bytes)
  using Raw = typename std::conditional<C == 4, uint2, uint32_t>::type;
  const int lane = threadIdx.x % 32;
  const int item = blockIdx.x * WARPS + threadIdx.x / 32;
  if (item >= B * max_segs) return;
  const int b = item / max_segs, s = item % max_segs;
  const int* ss = seg_start + (size_t)b * (K + 1);
  if (s >= ss[K]) return;
  // the cluster whose segments hold s: the last k with ss[k] <= s
  int lo = 0, hi = K - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (ss[mid] <= s)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int k = lo;
  const int first = offs[(size_t)b * K + k] + (s - ss[k]) * SEG;
  const int n = min(SEG, offs[(size_t)b * K + k] + (int)counts[(size_t)b * K + k] - first);
  const bf16* xb = x + (size_t)b * N * D + lane * C;
  const int* pb = perm + (size_t)b * N * slots + first;
  float acc[C];
#pragma unroll
  for (int u = 0; u < C; ++u) acc[u] = 0.f;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int mine = i0 + lane < n ? pb[i0 + lane] : 0;
    const int m = min(32, n - i0);
    for (int u0 = 0; u0 < m; u0 += INFLIGHT) {
      // every row's load is issued before the first add
      Raw raw[INFLIGHT];
#pragma unroll
      for (int u = 0; u < INFLIGHT; ++u) {
        const int tok = __shfl_sync(0xffffffffu, mine, u0 + u);
        raw[u] = u0 + u < m ? *reinterpret_cast<const Raw*>(xb + (size_t)tok * D) : Raw{};
      }
#pragma unroll
      for (int u = 0; u < INFLIGHT; ++u) {
        if (u0 + u < m) {
          const bf16* e = reinterpret_cast<const bf16*>(&raw[u]);
#pragma unroll
          for (int q = 0; q < C; ++q) acc[q] = __fadd_rn(acc[q], __bfloat162float(e[q]));
        }
      }
    }
  }
  float* out = partial + ((size_t)b * max_segs + s) * D + lane * C;
#pragma unroll
  for (int q = 0; q < C; ++q) out[q] = acc[q];
}

// a warp per (b, cluster): sums[b, k] = its segments' partial sums in segment
// order (0 for an empty cluster)
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
kmeans_combine_kernel(const float* __restrict__ partial, const int* __restrict__ seg_start, float* __restrict__ sums,
                      int B, int K, int max_segs) {
  constexpr int C = D / 32;
  const int lane = threadIdx.x % 32;
  const int item = blockIdx.x * WARPS + threadIdx.x / 32;
  if (item >= B * K) return;
  const int b = item / K, k = item % K;
  const int* ss = seg_start + (size_t)b * (K + 1);
  float acc[C];
#pragma unroll
  for (int q = 0; q < C; ++q) acc[q] = 0.f;
  for (int s = ss[k]; s < ss[k + 1]; ++s) {
    const float* p = partial + ((size_t)b * max_segs + s) * D + lane * C;
#pragma unroll
    for (int q = 0; q < C; ++q) acc[q] = __fadd_rn(acc[q], p[q]);
  }
  float* out = sums + (size_t)item * D + lane * C;
#pragma unroll
  for (int q = 0; q < C; ++q) out[q] = acc[q];
}

int num_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// one pass of variant V (VA: K5's). The tensor maps read (rows, D) bf16 in
// 64-column x 128-row boxes, 128B swizzle; the centroid map's rows past B *
// K read as zeros (those columns have |c|^2 = +inf)
template <int D, int V>
cudaError_t launch(const void* x, const void* c, int* labels, float* sums, float* counts, int* overflow, void* work,
                   int B, int N, int K, cudaStream_t stream) {
  constexpr int S = V == VD ? TIES : 1;
  constexpr int VA_ = V == VC ? VB : V;  // the assign C runs
  Work w;
  carve(work, B, N, K, D, S, &w);
  CUtensorMap tx, tc;
  if (!make_map(&tx, x, (long long)B * N, D) || !make_map(&tc, c, (long long)B * K, D)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (V != VE && (err = cudaMemsetAsync(w.hist, 0, (size_t)B * w.n_ch * K * sizeof(int), stream)) != cudaSuccess)
    return err;
  kmeans_csq_kernel<D><<<cdiv(B * w.k_pad, WARPS), WARPS * 32, 0, stream>>>(static_cast<const bf16*>(c), w.csq, B, K,
                                                                          w.k_pad);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int smem = AssignLayout<D>::SMEM;
  err = cudaFuncSetAttribute(kmeans_assign_kernel<D, VA_>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int items = B * cdiv(N, XT);
  kmeans_assign_kernel<D, VA_><<<items < num_sms() ? items : num_sms(), NTHREADS, smem, stream>>>(
      tx, tc, w.csq, labels, w.hist, overflow, B, N, K, w.k_pad, w.n_ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (V == VE) {
    if ((err = cudaMemsetAsync(sums, 0, (size_t)B * K * D * sizeof(float), stream)) != cudaSuccess) return err;
    return cudaMemsetAsync(counts, 0, (size_t)B * K * sizeof(float), stream);
  }
  kmeans_scan_kernel<<<B, SCAN_THREADS, 0, stream>>>(w.hist, w.offs, w.seg_start, counts, K, w.n_ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (V == VC) {
    kmeans_count_kernel<<<B * cdiv(K, 16), COUNT_WARPS * 32, 0, stream>>>(labels, counts, N, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int scatter_smem = WARPS * K * (int)sizeof(int);
  err = cudaFuncSetAttribute(kmeans_scatter_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, scatter_smem);
  if (err != cudaSuccess) return err;
  kmeans_scatter_kernel<S><<<cdiv(B * w.n_ch, WARPS), WARPS * 32, scatter_smem, stream>>>(labels, w.hist, w.perm, B,
                                                                                          N, K, w.n_ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kmeans_segsum_kernel<D><<<cdiv(B * w.max_segs, WARPS), WARPS * 32, 0, stream>>>(
      static_cast<const bf16*>(x), w.perm, w.offs, w.seg_start, counts, w.partial, B, N, K, w.max_segs, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kmeans_combine_kernel<D><<<cdiv(B * K, WARPS), WARPS * 32, 0, stream>>>(w.partial, w.seg_start, sums, B, K,
                                                                          w.max_segs);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int variant, const void* x, const void* c, int* l, float* su, float* co, int* ov, void* work,
                     int B, int N, int K, cudaStream_t s) {
  switch (variant) {
    case VA: return launch<D, VA>(x, c, l, su, co, ov, work, B, N, K, s);
    case VB: return launch<D, VB>(x, c, l, su, co, ov, work, B, N, K, s);
    case VC: return launch<D, VC>(x, c, l, su, co, ov, work, B, N, K, s);
    case VD: return launch<D, VD>(x, c, l, su, co, ov, work, B, N, K, s);
    case VE: return launch<D, VE>(x, c, l, su, co, ov, work, B, N, K, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bytes of the workspace one pass of `variant` (0-4 = A-E; A is K5's)
// needs at (B, N, K, D)
extern "C" long long svt_kmeans_lloyd_workspace(int B, int N, int K, int D, int variant) {
  return (long long)carve(nullptr, B, N, K, D, variant == VD ? TIES : 1, nullptr);
}

// x (B, N, D) bf16, c (B, K, D) bf16, both contiguous and 16-byte aligned;
// labels (B, N) int32 ((B, N, 4) for variant D), sums (B, K, D) f32, counts
// (B, K) f32; overflow (1,) int32 zeroed for variant D (tokens with more
// than 4 tied k), else unused; work the workspace
// (svt_kmeans_lloyd_workspace bytes, 256-byte aligned); D in {64, 128};
// variant 0-4 = A-E (A: K5's pass); K * 4 * WARPS bytes of shared memory
// for the scatter (K <= 14,000).
extern "C" int svt_kmeans_lloyd(const void* x, const void* c, void* labels, void* sums, void* counts, void* overflow,
                                void* work, int B, int N, int K, int D, int variant, void* stream) {
  if (B == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* l = static_cast<int*>(labels);
  float* su = static_cast<float*>(sums);
  float* co = static_cast<float*>(counts);
  int* ov = static_cast<int*>(overflow);
  if (D == 128) return (int)dispatch<128>(variant, x, c, l, su, co, ov, work, B, N, K, s);
  if (D == 64) return (int)dispatch<64>(variant, x, c, l, su, co, ov, work, B, N, K, s);
  return (int)cudaErrorInvalidValue;
}
