// The Hopper CTA body of the attention kernels, bf16, sm_90a: K1
// (csrc/block_sparse_attn.cu, chunked-CSR metadata), K3/K4
// (csrc/runs_attn.cu, run lists) and K7 (csrc/dense_qsplit.cu, one dense
// chunk a row) include it and differ only in where a CTA's chunks come from
// (a `Chunks` source, below) and in MODE, which only K7 sets:
//   MODE_NAT       K7's numerics: q pre-scaled by the scale alone, the
//                  scores and the running max in natural units, log2(e)
//                  folded into the FFMA of each exp2 argument
//   MODE_PINGPONG  FA3's schedule (one unmasked chunk a row of whole
//                  tiles): the two consumer warpgroups take turns issuing
//                  their products (named barriers), so one's softmax runs
//                  under the other's wgmma, and inside a warpgroup tile n's
//                  QK^T is issued with tile n-1's PV, so tile n's softmax
//                  runs under PV(n-1). K and V stages are freed apart and
//                  the ring has 3 stages at D = 128.
//   MODE_STATS     also write each row's softmax stats (m, l) for the ring
//                  merge (ops/attention.py return_stats): m the running max
//                  in natural-log units (the NEG_INF sentinel of a row that
//                  saw no live column kept as it is), l the f32 row sum.
//                  A separate instance: the instances without it keep their
//                  code.
//   MODE_SLAB      K1's temporal heads of the dual spec (placement-free
//                  SVG1): the CTA's q rows and every K/V tile are slot slabs,
//                  n_s = 128 / F slots x all F frames (F = num_frames), each
//                  loaded by one TMA box of a 4-D tensor map over (D, frame,
//                  slot, batch*head) of the original token layout. The box
//                  lands frame-fastest, so stage row r holds permuted
//                  position p = slab * P + r (P = n_s * F rows, the rest of
//                  the 128 padding that TMA never writes and the CTA zeroes
//                  once), and band_sink_perm is KIND_BAND_SINK's band and sink
//                  on p. A chunk is one K/V slab (SlabChunks); rows are
//                  stored to token (p % F) * frame_size + p / F.
//   MODE_PACKED    K3's run lists without a predicate (csrc/runs_attn.cu
//                  RunBoxes): each K/V stage is 8 slots of PACK_BOX rows,
//                  filled with the row's runs back to back, each run cut
//                  into slots from its first token, so a stage holds live
//                  keys of as many runs as fit and a run's last slot at most
//                  PACK_BOX - 1 keys past its end. The slots of one run in
//                  one stage load as one TMA box of 1, 2, 4 or 8 slots each
//                  (a binary split of their count), from 3-D tensor maps
//                  (D, Skv, batch*head) at the run's own token (any row;
//                  rows past Skv arrive as zeros): tm_k[l] and tm_v[l] box
//                  2^l slots. A stage's slots past the row's last run are
//                  zeros. The consumers mask each slot's rows past its run's
//                  end, deriving the slots from the same walk.
//
// Numerics (the TPU kernels' of K1, K3, K4): q pre-scaled by
// scale*log2(e) and rounded to bf16, the online softmax in f32 in the exp2 domain, P rounded to bf16 for
// PV while the row sum uses the f32 P, 0 for a row that sees no live column.
//
// What bounds it on the H100: the tensor-core FLOPs of QK^T and PV (4 D per
// visited pair); at D = 64 the per-pair softmax work (one exp2 and a few
// f32 operations a pair) comes close to it. So the design keeps the tensor
// cores fed from shared memory that TMA fills ahead, shares each K/V tile
// across 128 q rows, and keeps masking off the tiles that do not need it:
// - One CTA of three warpgroups owns BQ = 128 q rows of one (batch*head)
//   row: a producer warpgroup, whose first thread issues every load, and
//   two consumer warpgroups of 64 rows each. setmaxnreg moves the
//   producer's registers to the consumers (40 / 232).
// - The producer walks the CTA's chunks in 128-token tiles and keeps TMA
//   loads of the K and V tiles in flight in a ring of STAGES stages
//   (mbarriers: full K, full V and empty per stage). Tiles are 128B
//   swizzled (two 64-column boxes a row at D = 128). Q is loaded once by
//   TMA; each consumer warpgroup scales and rounds its 64 rows in shared
//   memory.
// - Each consumer warpgroup computes S = Q K^T with wgmma m64n128k16 (both
//   operands in shared memory), masks the window (tiles that straddle
//   [lo, hi)) and, on masked chunks, the kind's predicate: first over its
//   whole 64 x 128 tile (mask_tile: a tile allowed nowhere is skipped, one
//   allowed everywhere needs no per-pair test), then per pair on the mixed
//   tiles. It runs the exp2 online softmax in registers, converts P to
//   bf16 in registers and accumulates O += P V with wgmma (A from
//   registers, V the transposed B operand in shared memory), then frees the
//   stage.
// - Work items (batch*head, 128-row q tile) run heaviest first: the grid
//   is ordered by `order` (ops/attention.py work_order / runs_work_order:
//   tokens visited, descending), so the items that visit most columns
//   start first instead of running on alone at the end.
//
// A chunk source has
//   template <class F> void walk(F&& f) const
// which calls f(s0, lo, hi, masked) for each chunk in order: s0 the chunk's
// first token in the (batch*head) row of K/V, a multiple of 128; [lo, hi)
// its live columns relative to s0; masked whether the chunk evaluates the
// kind's predicate. The producer and both consumer warpgroups walk the same
// sequence, so it must depend on nothing but the metadata. A tile is
// loaded from s0 + (lo & ~127) in 128-token steps up to hi; every tile
// start is a multiple of 128, and a tile at or past hi is not loaded.
// MODE_PACKED's source has instead a Cursor type, whose members p and b
// are the current run's next token and its end, and
//   void start(Cursor&) const              the cursor at the row's first run
//   bool more(const Cursor&) const         whether a token is left
//   void advance(Cursor&, int slots) const past that many slots of the run
//                                          (to the next run once past b)

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mask_pred.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;  // q rows a CTA: two consumer warpgroups of 64
constexpr int BK = 128;  // K/V tokens a tile
constexpr int NTHREADS = 384;
constexpr int SUB = 128;
constexpr int ROW_BYTES = 128;  // one 64-column box row, the 128B swizzle span
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float NEG_INF = -0.7f * 3.402823466e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MODE_NAT = 1, MODE_PINGPONG = 2, MODE_STATS = 4, MODE_SLAB = 8, MODE_PACKED = 16;
// MODE_PACKED's slot: a multiple of 8 rows (1024 bytes), so every box lands on
// a swizzle period and the wgmma descriptors read a stage as one tile; the
// consumers' column mask takes 4 bits a slot (16 rows), 8 slots a stage
constexpr int PACK_BOX = 16;
static_assert(PACK_BOX == 16 && BK == 8 * PACK_BOX, "packed slots");

// PP: the ping-pong ring (MODE_PINGPONG): 3 stages at D = 128 and a
// separate empty barrier for the K and the V of each stage
template <int D, bool PP = false>
struct Layout {
  static constexpr int STAGES = D == 128 ? (PP ? 3 : 2) : 4;
  static constexpr int TILE_BYTES = BK * D * 2;  // a K or a V tile
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;
  static constexpr int BARS_A_STAGE = PP ? 4 : 3;
  // barriers: full K, full V, empty (K's with PP), [empty V with PP] (per
  // stage), Q; 1024 bytes to align the base
  static constexpr int SMEM = BAR_OFF + (BARS_A_STAGE * STAGES + 1) * 8 + 1024;
  // more than half an SM's shared memory: one CTA an SM, so the consumers'
  // setmaxnreg.inc always finds the producer's registers
  static_assert(SMEM > 232448 / 2 && SMEM <= 232448, "shared memory layout");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a 64-column x 128-row box at (column c0, row c1) of a 2-D tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// a 64-column box at (column c0, row c1, batch*head c2) of a 3-D tensor map (MODE_PACKED)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a 64-column box at (column c0, c1, c2, c3) of a 4-D tensor map (MODE_SLAB)
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

// wait at named barrier `id` until `n` threads have reached it
__device__ __forceinline__ void named_sync(int id, int n) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory"); }

// keeps the compiler from moving reads of wgmma accumulators above the wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128B swizzle; lbo/sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

#define F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
              "+f"(d[i + 6]), "+f"(d[i + 7])
#define F32(i) F8(i), F8(i + 8), F8(i + 16), F8(i + 24)

// d[64] (+)= A(64 x 16, K-major smem) . B(128 x 16, K-major smem)^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : F32(0), F32(32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] += A(64 x 16, registers) . B(16 x 128, MN-major smem)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F32(0), F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A(64 x 16, registers) . B(16 x 64, MN-major smem)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F32
#undef F8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> packed bf16x2, `lo` in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 128 tokens) = this warpgroup's Q rows . the K tile^T. Both are
// K-major with 128B rows: a 16-deep k-step is 32 bytes into the row, the
// next 64 columns are the next box (rows x 128 bytes further).
template <int D>
__device__ __forceinline__ void qk_gemm(float (&s)[64], uint32_t q_addr, uint32_t k_addr) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = sw128_desc(q_addr + (kk / 4) * BQ * ROW_BYTES + col, 16, 8 * ROW_BYTES);
    const uint64_t db = sw128_desc(k_addr + (kk / 4) * BK * ROW_BYTES + col, 16, 8 * ROW_BYTES);
    wgmma_ss_n128(s, da, db, kk > 0);
  }
  wg_commit();
}

// O (64 x D) += P (64 x 128 tokens, bf16 A fragments) . the V tile. V is
// MN-major for this product: a 16-token k-step is 16 rows further; the
// next 64 output columns are the next box (LBO).
template <int D>
__device__ __forceinline__ void pv_gemm(float (&o)[D / 2], const uint32_t (&p)[32], uint32_t v_addr) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    const uint64_t db = sw128_desc(v_addr + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 8 * ROW_BYTES);
    if constexpr (D == 128)
      wgmma_rs_n128(o, a, db);
    else
      wgmma_rs_n64(o, a, db);
  }
  wg_commit();
}

// the online softmax state of a thread's rows g and g + 8 (l: this thread's
// partial row sum; the quad adds its four at the end)
struct RowState {
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
};

// One K/V tile for a consumer warpgroup (its K has arrived): S = Q K^T, the
// window where the tile straddles [lo, hi) and, MASKED with cls ==
// TILE_SOME, the kind's predicate per pair; the exp2 online softmax; then,
// once V has arrived, O += P V.
// NAT: K7's natural-unit scores (MODE_NAT), log2(e) folded into the exp2 FFMA.
// SLAB (MODE_SLAB): the tile is a slab whose columns [hi, BK) are padding
// (lo == t0 == 0); hi > 64 unless cls == TILE_SOME, so a tile without the
// predicate masks only its upper half.
// PACKED (MODE_PACKED): cls is instead a bit a slot (the same in every
// thread), set where the slot has a masked column; there the columns whose
// bit in `live` is clear are masked. Bit 2 * (i / 4) + (i & 1) of `live`
// is the column of s[i] (8 * (i / 4) + 2 * t4 + (i & 1)): 4 bits a slot,
// its columns 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9; s[8 k .. 8 k + 7] are
// slot k's.
template <int D, int KIND, bool MASKED, bool NAT = false, bool SLAB = false, bool PACKED = false>
__device__ __forceinline__ void attend_tile(float (&acc)[D / 2], float (&s)[64], RowState& st, uint32_t q_addr,
                                            uint32_t k_addr, uint32_t v_addr, uint32_t v_bar, uint32_t phase, int t0,
                                            int lo, int hi, int cls, const MaskArgs& mk, int qp0, int kbase, int t4,
                                            uint32_t live = 0) {
  qk_gemm<D>(s, q_addr, k_addr);
  wg_wait0();
  reg_fence(s);

  if constexpr (PACKED) {
#pragma unroll
    for (int k = 0; k < BK / PACK_BOX; ++k) {
      if (cls & (1 << k)) {
#pragma unroll
        for (int i = 8 * k; i < 8 * k + 8; ++i) {
          if (!((live >> (2 * (i / 4) + (i & 1))) & 1u)) s[i] = NEG_INF;
        }
      }
    }
  } else if constexpr (SLAB) {
    if (cls == TILE_SOME) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = 8 * (i / 4) + 2 * t4 + (i & 1);
        if (!(col < hi && mask_allows<KIND>(mk, qp0 + ((i & 2) ? 8 : 0), kbase + col))) s[i] = NEG_INF;
      }
    } else if (hi < BK) {
#pragma unroll
      for (int i = 32; i < 64; ++i) {
        if (8 * (i / 4) + 2 * t4 + (i & 1) >= hi) s[i] = NEG_INF;
      }
    }
  } else if ((MASKED && cls == TILE_SOME) || t0 < lo || t0 + BK > hi) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = t0 + 8 * (i / 4) + 2 * t4 + (i & 1);
      bool ok = col >= lo && col < hi;
      if (MASKED && cls == TILE_SOME && ok) ok = mask_allows<KIND>(mk, qp0 + ((i & 2) ? 8 : 0), kbase + col);
      if (!ok) s[i] = NEG_INF;
    }
  }

  // online softmax, exp2 domain; a row lives in the 4 threads of a quad
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(st.m0, mx0), mn1 = fmaxf(st.m1, mx1);
  const float alpha0 = NAT ? ex2((st.m0 - mn0) * LOG2E) : ex2(st.m0 - mn0);
  const float alpha1 = NAT ? ex2((st.m1 - mn1) * LOG2E) : ex2(st.m1 - mn1);
  // a row with no live column so far exponentiates against 0: p == 0
  const float ms0 = mn0 > 0.5f * NEG_INF ? mn0 : 0.f, ms1 = mn1 > 0.5f * NEG_INF ? mn1 : 0.f;
  const float nm0 = -ms0 * LOG2E, nm1 = -ms1 * LOG2E;  // NAT only
  st.m0 = mn0;
  st.m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    const float p0 = NAT ? ex2(fmaf(s[i], LOG2E, nm0)) : ex2(s[i] - ms0);
    const float p1 = NAT ? ex2(fmaf(s[i + 1], LOG2E, nm0)) : ex2(s[i + 1] - ms0);
    const float p2 = NAT ? ex2(fmaf(s[i + 2], LOG2E, nm1)) : ex2(s[i + 2] - ms1);
    const float p3 = NAT ? ex2(fmaf(s[i + 3], LOG2E, nm1)) : ex2(s[i + 3] - ms1);
    sum0 += p0 + p1;
    sum1 += p2 + p3;
    p[i / 2] = pack_f2(p0, p1);
    p[i / 2 + 1] = pack_f2(p2, p3);
  }
  st.l0 = st.l0 * alpha0 + sum0;
  st.l1 = st.l1 * alpha1 + sum1;
#pragma unroll
  for (int i = 0; i < D / 2; i += 4) {
    acc[i] *= alpha0;
    acc[i + 1] *= alpha0;
    acc[i + 2] *= alpha1;
    acc[i + 3] *= alpha1;
  }

  mbar_wait(v_bar, phase);
  pv_gemm<D>(acc, p, v_addr);
  wg_wait0();
  reg_fence(acc);
}

// The online softmax of one whole S tile in place (S becomes f32 P), FA3's
// part of a tile between its QK^T and its PV: the row max, the rescale
// factors alpha of O (applied by the caller once PV(n-1) is done) and the
// row sums. Straight-line code: it runs while a wgmma is in flight, and a
// branch there makes ptxas serialize the wgmma. NAT as attend_tile.
template <bool NAT>
__device__ __forceinline__ void softmax_tile(float (&s)[64], RowState& st, float& alpha0, float& alpha1) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(st.m0, mx0), mn1 = fmaxf(st.m1, mx1);
  const float L = NAT ? LOG2E : 1.f;
  alpha0 = ex2((st.m0 - mn0) * L);
  alpha1 = ex2((st.m1 - mn1) * L);
  const float nm0 = -mn0 * L, nm1 = -mn1 * L;
  st.m0 = mn0;
  st.m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    s[i] = ex2(fmaf(s[i], L, nm0));
    s[i + 1] = ex2(fmaf(s[i + 1], L, nm0));
    s[i + 2] = ex2(fmaf(s[i + 2], L, nm1));
    s[i + 3] = ex2(fmaf(s[i + 3], L, nm1));
    sum0 += s[i] + s[i + 1];
    sum1 += s[i + 2] + s[i + 3];
  }
  st.l0 = st.l0 * alpha0 + sum0;
  st.l1 = st.l1 * alpha1 + sum1;
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], float alpha0, float alpha1) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 4) {
    acc[i] *= alpha0;
    acc[i + 1] *= alpha0;
    acc[i + 2] *= alpha1;
    acc[i + 3] *= alpha1;
  }
}

// P (f32, in the S registers) -> bf16 A fragments
__device__ __forceinline__ void pack_p(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    p[i / 2] = pack_f2(s[i], s[i + 1]);
    p[i / 2 + 1] = pack_f2(s[i + 2], s[i + 3]);
  }
}

// without a branch (predicated): arrive on an mbarrier if lane == 0, on a
// named barrier (without waiting) if `on`
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar, int lane) {
  asm volatile("{\n .reg .pred p;\n setp.eq.u32 p, %1, 0;\n @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
               "r"(lane)
               : "memory");
}
__device__ __forceinline__ void named_arrive_if(bool on, int id, int n) {
  asm volatile("{\n .reg .pred p;\n setp.ne.u32 p, %0, 0;\n @p bar.arrive %1, %2;\n}\n" ::"r"((int)on), "r"(id), "r"(n)
               : "memory");
}

// MODE_PINGPONG's consumer warpgroup (FA3's schedule) over one unmasked
// chunk a row whose window [lo, hi) covers whole 128-token tiles (K7's
// dense chunk). Named barriers 3 and 4 hand the tensor cores from one
// warpgroup to the other: a warpgroup waits for its turn (3 + wg), issues
// its products and passes the turn on; warpgroup 1 passes first so that
// warpgroup 0 starts, and does not pass after its last tile (each barrier
// then sees as many arrivals as waits). Tile 0: S = QK^T(0), its softmax.
// Tile n > 0: wait for K(n) and V(n-1); in turn issue QK^T(n) and O +=
// P(n-1) V(n-1) back to back; wait for the QK^T (wgmma groups retire in
// order), free K(n), run the softmax of tile n while PV(n-1) runs, wait for
// it, free V(n-1), scale O by alpha(n) and round P(n) to bf16 in the
// registers PV(n-1) read. After the last tile: its PV. No branch lies
// between a wgmma's issue and its wait.
template <int D, bool NAT, int STAGES, class Chunks>
__device__ __forceinline__ void pingpong_consumer(float (&acc)[D / 2], float (&s)[64], RowState& st,
                                                  const Chunks& chunks, uint32_t q_addr, uint32_t k_base,
                                                  uint32_t v_base, uint32_t bar, int wg, int lane) {
  constexpr int TILE = BK * D * 2;
  auto full_k = [&](int i) { return bar + 8 * i; };
  auto full_v = [&](int i) { return bar + 8 * (STAGES + i); };
  auto empty_k = [&](int i) { return bar + 8 * (2 * STAGES + i); };
  auto empty_v = [&](int i) { return bar + 8 * (3 * STAGES + i); };
  int lo = 0, hi = 0;
  chunks.walk([&](int, int l, int h, bool) {
    lo = l;
    hi = h;
  });
  const int n_tiles = (hi - lo) / BK;
  if (n_tiles <= 0) return;
  uint32_t p[32];
  float alpha0, alpha1;
  int stage = 0, pstage = 0;
  uint32_t phase = 0, pphase = 0;
  auto advance = [&]() {
    pstage = stage;
    pphase = phase;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  named_arrive_if(wg == 1, 3, 256);
  // tile 0
  mbar_wait(full_k(stage), phase);
  named_sync(3 + wg, 256);
  qk_gemm<D>(s, q_addr, k_base + stage * TILE);
  named_arrive_if(wg == 0 || n_tiles > 1, 4 - wg, 256);
  wg_wait0();
  reg_fence(s);
  mbar_arrive_lane0(empty_k(stage), lane);
  softmax_tile<NAT>(s, st, alpha0, alpha1);
  pack_p(p, s);
  advance();
  for (int n = 1; n < n_tiles; ++n) {
    mbar_wait(full_k(stage), phase);
    mbar_wait(full_v(pstage), pphase);
    named_sync(3 + wg, 256);
    reg_fence(s);
    reg_fence(acc);
    qk_gemm<D>(s, q_addr, k_base + stage * TILE);
    pv_gemm<D>(acc, p, v_base + pstage * TILE);
    named_arrive_if(wg == 0 || n + 1 < n_tiles, 4 - wg, 256);
    wg_wait1();
    reg_fence(s);
    mbar_arrive_lane0(empty_k(stage), lane);
    softmax_tile<NAT>(s, st, alpha0, alpha1);
    wg_wait0();
    reg_fence(acc);
    reg_fence(p);  // PV(n-1) read p until here: its registers stay p's
    mbar_arrive_lane0(empty_v(pstage), lane);
    rescale<D>(acc, alpha0, alpha1);
    pack_p(p, s);
    advance();
  }
  mbar_wait(full_v(pstage), pphase);
  reg_fence(acc);
  pv_gemm<D>(acc, p, v_base + pstage * TILE);
  wg_wait0();
  reg_fence(acc);
  mbar_arrive_lane0(empty_v(pstage), lane);
}

// the CTA's work item: (batch*head) row bh and its q tile [q0, q0 + BQ)
struct WorkItem {
  int bh, q0;
};

__device__ __forceinline__ WorkItem work_item(const int* __restrict__ order, int Sq) {
  const int nT = Sq / BQ;
  const int item = order[blockIdx.x];
  return {item / nT, (item % nT) * BQ};
}

// The CTA body (launch with NTHREADS threads and Layout<D, MODE &
// MODE_PINGPONG>::SMEM bytes of dynamic shared memory): q rows [q0, q0 + BQ)
// of row bh attend to the chunks of `chunks`; the mask predicate of KIND at
// (q + aux[2], k + aux[3]) with text_end aux[0] (the text kinds) on masked
// chunks. MODE: see the top of this file; with MODE_PINGPONG every chunk is
// taken as unmasked (K7's dense chunk). frame_size and num_frames are
// MODE_SLAB's: there it.q0 is the q slab's first permuted position, the
// chunks are K/V slabs (SlabChunks in csrc/block_sparse_attn.cu), KIND is
// KIND_BAND_SINK on permuted positions and the aux offsets are not read.
// m_out and l_out ((BH, Sq) f32) are MODE_STATS's.
template <int D, int KIND, int MODE = 0, class Chunks>
__device__ __forceinline__ void attn_cta(const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                         bf16* __restrict__ o, const Chunks& chunks, WorkItem it, int Sq, int Skv,
                                         const int* __restrict__ aux, int band_width, int sink_size, int video_len,
                                         float q_scale, int frame_size = 0, int num_frames = 0,
                                         float* __restrict__ m_out = nullptr, float* __restrict__ l_out = nullptr) {
  constexpr bool NAT = (MODE & MODE_NAT) != 0, PP = (MODE & MODE_PINGPONG) != 0;
  constexpr bool STATS = (MODE & MODE_STATS) != 0, SLAB = (MODE & MODE_SLAB) != 0;
  constexpr bool PACKED = (MODE & MODE_PACKED) != 0;
  static_assert(!(STATS && (NAT || PP)), "stats come with K1/K3/K4's numerics and schedule");
  static_assert(!(SLAB && (NAT || PP)), "slabs come with K1's numerics and schedule");
  static_assert(!(PACKED && (NAT || PP || SLAB)), "packed stages come with K3's numerics and schedule");
  using LY = Layout<D, PP>;
  constexpr int STAGES = LY::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sq = base, bar = base + LY::BAR_OFF;
  auto full_k = [&](int s) { return bar + 8 * s; };
  auto full_v = [&](int s) { return bar + 8 * (STAGES + s); };
  auto empty = [&](int s) { return bar + 8 * (2 * STAGES + s); };  // with PP: K's
  auto empty_v = [&](int s) { return bar + 8 * (3 * STAGES + s); };  // PP only
  const uint32_t q_full = bar + 8 * LY::BARS_A_STAGE * STAGES;
  const int bh = it.bh, q0 = it.q0;
  // MODE_SLAB's geometry: n_s slots a slab, P rows of the 128 live, S
  // tokens (and permuted positions) in the video
  const int n_s = SLAB ? BQ / num_frames : 1, P = n_s * num_frames, S = frame_size * num_frames;

  if constexpr (SLAB) {
    // rows [P, 128) of the q tile and of every K and V stage, 16 KB boxes
    // side by side from the base: TMA never writes them, and the zero V rows
    // keep the masked columns' 0 * V finite
    const int pad16 = (BQ - P) * ROW_BYTES / 16;
    for (int i = threadIdx.x; i < (D / 64) * (1 + 2 * STAGES) * pad16; i += NTHREADS)
      reinterpret_cast<uint4*>(gbase + (i / pad16) * BK * ROW_BYTES + P * ROW_BYTES)[i % pad16] =
          make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
      if constexpr (PP) mbar_init(empty_v(s), 8);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if constexpr (SLAB) {
      if (threadIdx.x == 0) {
        // q slab q0 / P and each K/V slab: one box (64 columns, F frames, n_s
        // slots) a 64-column half; rows past slot frame_size - 1 arrive as zeros
        const uint32_t slab_bytes = P * ROW_BYTES * (D / 64);
        mbar_expect_tx(q_full, slab_bytes);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_4d(sq + cb * BQ * ROW_BYTES, tm_q, q_full, cb * 64, 0, q0 / num_frames, bh);
        int stage = 0;
        uint32_t phase = 0;
        chunks.walk([&](int slab, int, int, bool) {
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t ks = base + LY::K_OFF + stage * LY::TILE_BYTES;
          const uint32_t vs = base + LY::V_OFF + stage * LY::TILE_BYTES;
          mbar_expect_tx(full_k(stage), slab_bytes);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb)
            tma_load_4d(ks + cb * BK * ROW_BYTES, tm_k, full_k(stage), cb * 64, 0, slab * n_s, bh);
          mbar_expect_tx(full_v(stage), slab_bytes);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb)
            tma_load_4d(vs + cb * BK * ROW_BYTES, tm_v, full_v(stage), cb * 64, 0, slab * n_s, bh);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        });
      }
    } else if constexpr (PACKED) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(q_full, LY::Q_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) tma_load(sq + cb * BQ * ROW_BYTES, tm_q, q_full, cb * 64, bh * Sq + q0);
        int stage = 0;
        uint32_t phase = 0;
        typename Chunks::Cursor cur;
        chunks.start(cur);
        while (chunks.more(cur)) {
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t ks = base + LY::K_OFF + stage * LY::TILE_BYTES;
          const uint32_t vs = base + LY::V_OFF + stage * LY::TILE_BYTES;
          mbar_expect_tx(full_k(stage), LY::TILE_BYTES);
          mbar_expect_tx(full_v(stage), LY::TILE_BYTES);
          // the stage's slots j, run segment by run segment: m slots of a run
          // (or, past the row's last run, the rest as zeros from row Skv) in
          // boxes of 8, 4, 2, 1 slots
          for (int j = 0; j < BK / PACK_BOX;) {
            int tok = Skv, m = BK / PACK_BOX - j;
            const bool run = chunks.more(cur);
            if (run) {
              tok = cur.p;
              m = min(m, (cur.b - cur.p + PACK_BOX - 1) / PACK_BOX);
              chunks.advance(cur, m);
            }
#pragma unroll
            for (int l = 3; l >= 0; --l) {
              if (m & (1 << l)) {
                const uint32_t row = j * PACK_BOX * ROW_BYTES;
#pragma unroll
                for (int cb = 0; cb < D / 64; ++cb) {
                  tma_load_3d(ks + cb * BK * ROW_BYTES + row, tm_k + l, full_k(stage), cb * 64, tok, bh);
                  tma_load_3d(vs + cb * BK * ROW_BYTES + row, tm_v + l, full_v(stage), cb * 64, tok, bh);
                }
                if (run) tok += PACK_BOX << l;
                j += 1 << l;
              }
            }
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, LY::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) tma_load(sq + cb * BQ * ROW_BYTES, tm_q, q_full, cb * 64, bh * Sq + q0);
      int stage = 0;
      uint32_t phase = 0;
      chunks.walk([&](int s0, int lo, int hi, bool) {
        const int row0 = bh * Skv + s0;
        for (int t0 = lo & ~(BK - 1); t0 < hi; t0 += BK) {
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t ks = base + LY::K_OFF + stage * LY::TILE_BYTES;
          const uint32_t vs = base + LY::V_OFF + stage * LY::TILE_BYTES;
          mbar_expect_tx(full_k(stage), LY::TILE_BYTES);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb) tma_load(ks + cb * BK * ROW_BYTES, tm_k, full_k(stage), cb * 64, row0 + t0);
          if constexpr (PP) mbar_wait(empty_v(stage), phase ^ 1);
          mbar_expect_tx(full_v(stage), LY::TILE_BYTES);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb) tma_load(vs + cb * BK * ROW_BYTES, tm_v, full_v(stage), cb * 64, row0 + t0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      });
    }
  } else {
    // consumer warpgroups: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;

    // scale and round this warpgroup's 64 q rows in place (elementwise: the
    // swizzle does not matter), then make them visible to wgmma
    mbar_wait(q_full, 0);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      uint4* rows = reinterpret_cast<uint4*>(gbase + cb * BQ * ROW_BYTES + wg * 64 * ROW_BYTES);
#pragma unroll
      for (int i = tid; i < 64 * ROW_BYTES / 16; i += 128) {
        uint4 raw4 = rows[i];
        bf16* e = reinterpret_cast<bf16*>(&raw4);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * q_scale);
        rows[i] = raw4;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    const uint32_t q_addr = sq + wg * 64 * ROW_BYTES;
    const int qw = q0 + wg * 64 + (SLAB ? 0 : aux[2]);  // this warpgroup's first q position
    const int qp0 = qw + warp * 16 + g;
    const int koff = SLAB ? 0 : aux[3];
    const MaskArgs mk = {band_width, sink_size, video_len, KIND == KIND_BAND_SINK ? 0 : aux[0]};

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    RowState st;
    int stage = 0;
    uint32_t phase = 0;

    if constexpr (PP) {
      pingpong_consumer<D, NAT, STAGES>(acc, s, st, chunks, q_addr, base + LY::K_OFF, base + LY::V_OFF, bar, wg,
                                        lane);
    } else if constexpr (SLAB) {
      // a chunk is K/V slab `slab`, live columns [0, hi), permuted positions
      // slab * P + column; the window needs the predicate's column test below 64
      chunks.walk([&](int slab, int, int hi, bool) {
        const int kbase = slab * P;
        int cls = mask_tile<KIND>(mk, qw, qw + 63, kbase, kbase + hi - 1);
        if (hi < 64 && cls == TILE_ALL) cls = TILE_SOME;
        mbar_wait(full_k(stage), phase);
        if (cls == TILE_NONE)
          mbar_wait(full_v(stage), phase);
        else
          attend_tile<D, KIND, true, false, true>(acc, s, st, q_addr, base + LY::K_OFF + stage * LY::TILE_BYTES,
                                                  base + LY::V_OFF + stage * LY::TILE_BYTES, full_v(stage), phase, 0, 0,
                                                  hi, cls, mk, qp0, kbase, t4);
        if (lane == 0) mbar_arrive(empty(stage));
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      });
    } else if constexpr (PACKED) {
      // a stage's slots from the producer's walk, run segment by run segment:
      // m slots of a run, all live but the last, whose live rows are `last`;
      // `part` marks the slots with a masked column: a segment's last slot
      // short of PACK_BOX and the slots past the row's last run (the same in
      // every thread)
      typename Chunks::Cursor cur;
      chunks.start(cur);
      const int c0 = 2 * t4;
      while (chunks.more(cur)) {
        uint32_t live = 0;
        int part = 0;
        int j = 0;
        while (j < BK / PACK_BOX && chunks.more(cur)) {
          const int left = cur.b - cur.p;
          const int m = min(BK / PACK_BOX - j, (left + PACK_BOX - 1) / PACK_BOX);
          const int last = min(left - PACK_BOX * (m - 1), PACK_BOX);
          live |= ((1u << (4 * (m - 1))) - 1u) << (4 * j);
          live |= ((uint32_t)(c0 < last) | (uint32_t)(c0 + 1 < last) << 1 | (uint32_t)(c0 + 8 < last) << 2 |
                   (uint32_t)(c0 + 9 < last) << 3)
                  << (4 * (j + m - 1));
          part |= (last < PACK_BOX) << (j + m - 1);
          chunks.advance(cur, m);
          j += m;
        }
        part |= (0xff << j) & 0xff;
        mbar_wait(full_k(stage), phase);
        attend_tile<D, KIND, false, false, false, true>(
            acc, s, st, q_addr, base + LY::K_OFF + stage * LY::TILE_BYTES, base + LY::V_OFF + stage * LY::TILE_BYTES,
            full_v(stage), phase, 0, 0, BK, part, mk, qp0, 0, t4, live);
        if (lane == 0) mbar_arrive(empty(stage));
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else {

    auto release = [&]() {
      if (lane == 0) mbar_arrive(empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    chunks.walk([&](int s0, int lo, int hi, bool masked) {
      const int kbase = s0 + koff;
      const uint32_t k0 = base + LY::K_OFF, v0 = base + LY::V_OFF;
      if (!masked) {
        for (int t0 = lo & ~(BK - 1); t0 < hi; t0 += BK) {
          mbar_wait(full_k(stage), phase);
          attend_tile<D, KIND, false, NAT>(acc, s, st, q_addr, k0 + stage * LY::TILE_BYTES, v0 + stage * LY::TILE_BYTES,
                                      full_v(stage), phase, t0, lo, hi, TILE_ALL, mk, qp0, kbase, t4);
          release();
        }
      } else {
        // the predicate over this warpgroup's 64 rows x the tile's live
        // columns first: a tile it allows nowhere changes nothing (p == 0,
        // alpha == 1) and is skipped; one it allows everywhere only applies
        // the window
        for (int t0 = lo & ~(BK - 1); t0 < hi; t0 += BK) {
          const int cls = mask_tile<KIND>(mk, qw, qw + 63, kbase + max(t0, lo), kbase + min(t0 + BK, hi) - 1);
          mbar_wait(full_k(stage), phase);
          if (cls == TILE_NONE)
            mbar_wait(full_v(stage), phase);
          else
            attend_tile<D, KIND, true, NAT>(acc, s, st, q_addr, k0 + stage * LY::TILE_BYTES, v0 + stage * LY::TILE_BYTES,
                                       full_v(stage), phase, t0, lo, hi, cls, mk, qp0, kbase, t4);
          release();
        }
      }
    });
    }

    // normalise and write rows g and g + 8 of this warp's 16; a row that
    // never saw a live column has acc == 0, l == 0 -> 0
    float l0 = st.l0, l1 = st.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
    if constexpr (SLAB) {
      // slab row r holds p = q0 + r, token (p % F) * frame_size + p / F;
      // padding rows and p >= S are not stored
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + warp * 16 + g + 8 * h, p = q0 + r;
        if (r < P && p < S) {
          const size_t row = (size_t)bh * Sq + (p % num_frames) * frame_size + p / num_frames;
          const float inv = h ? inv1 : inv0, m = h ? st.m1 : st.m0;
          if (STATS && t4 == 0) {
            m_out[row] = m > 0.5f * NEG_INF ? m / LOG2E : m;
            l_out[row] = h ? l1 : l0;
          }
          bf16* orow = o + row * D + 2 * t4;
#pragma unroll
          for (int i = 0; i < D / 2; i += 4)
            *reinterpret_cast<__nv_bfloat162*>(orow + 2 * i) =
                __floats2bfloat162_rn(acc[i + 2 * h] * inv, acc[i + 2 * h + 1] * inv);
        }
      }
      // the q padding past the video, rows [S, Sq): the last slab writes
      // them as rows that saw no live column
      if (q0 + P >= S) {
        const int ct = threadIdx.x - 128;
        uint4* pad = reinterpret_cast<uint4*>(o + ((size_t)bh * Sq + S) * D);
        for (int i = ct; i < (Sq - S) * D / 8; i += 256) pad[i] = make_uint4(0, 0, 0, 0);
        if constexpr (STATS) {
          for (int i = ct; i < Sq - S; i += 256) {
            m_out[(size_t)bh * Sq + S + i] = NEG_INF;
            l_out[(size_t)bh * Sq + S + i] = 0.f;
          }
        }
      }
      return;
    }
    if constexpr (STATS) {
      // the quad's four threads hold the same m and (summed) l
      const size_t row = (size_t)bh * Sq + q0 + wg * 64 + warp * 16 + g;
      if (t4 == 0) {
        m_out[row] = st.m0 > 0.5f * NEG_INF ? st.m0 / LOG2E : st.m0;
        m_out[row + 8] = st.m1 > 0.5f * NEG_INF ? st.m1 / LOG2E : st.m1;
        l_out[row] = l0;
        l_out[row + 8] = l1;
      }
    }
    bf16* orow = o + ((size_t)bh * Sq + q0 + wg * 64 + warp * 16 + g) * D + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      const int col = 2 * i;  // 8 * (i / 4)
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(acc[i] * inv0, acc[i + 1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * D + col) =
          __floats2bfloat162_rn(acc[i + 2] * inv1, acc[i + 3] * inv1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, D) bf16, row-major, read in 64-column x 128-row boxes with the 128B swizzle
bool make_map(CUtensorMap* map, const void* ptr, long long rows, int D) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 128};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the tensor maps of q (BH * Sq rows) and k, v (BH * Skv rows)
bool make_qkv_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv, const void* q, const void* k, const void* v,
                   int BH, int Sq, int Skv, int D) {
  return make_map(tq, q, (long long)BH * Sq, D) && make_map(tk, k, (long long)BH * Skv, D) &&
         make_map(tv, v, (long long)BH * Skv, D);
}

}  // namespace
