// The token-level mask predicates of the attention kernels (one copy): the
// CTA body csrc/hopper_attn.cuh of K1 (csrc/block_sparse_attn.cu) and K3/K4
// (csrc/runs_attn.cu) includes it.
//
// ops/mask_spec.py apply_mask_spec at global positions (q, k), strict band
// |q - k| < band_width. text_end is aux[0], the end of the live text tokens:
//   KIND_BAND_SINK: band | k < sink_size
//   KIND_HYVIDEO (text last; text_end = video_len + prompt_length):
//     (q < text_end & k < text_end & (band | k in [video_len, text_end) | q in [video_len, text_end)))
//     | (q >= text_end & k >= text_end)
//   KIND_COG (text first; text_end = prompt_length): band | k < text_end | q < text_end
//   KIND_BAND_SINK_PERM (placement-free SVG1's temporal heads): band_sink at
//     the permuted positions p(x) = (x % frame_size) * num_frames + x / frame_size
// Kind none never calls it (it runs the band_sink instance without the
// predicate). The kind is a template parameter so that the band_sink
// kernels carry no registers for the text kinds' scalars.

#pragma once

namespace {

constexpr int KIND_BAND_SINK = 1;
constexpr int KIND_HYVIDEO = 2;
constexpr int KIND_COG = 3;
constexpr int KIND_BAND_SINK_PERM = 4;

struct MaskArgs {
  int band_width, sink_size, video_len, text_end;
  int frame_size, num_frames;  // KIND_BAND_SINK_PERM only
};

// the token-major position of x: frame x / fs, slot x % fs -> slot * F + frame
__device__ __forceinline__ int perm_pos(const MaskArgs& mk, int x) {
  const int f = x / mk.frame_size;
  return (x - f * mk.frame_size) * mk.num_frames + f;
}

// a conservative hull [pmin, pmax] of perm_pos over [x0, x1]: exact inside
// one frame; across frames p takes a frame index (>= f0) at slot 0 and at
// most (fs - 1) * F + f1 (ops/mask_spec.py full_block_allowed's p_hull)
__device__ __forceinline__ void perm_hull(const MaskArgs& mk, int x0, int x1, int& pmin, int& pmax) {
  const int fs = mk.frame_size, F = mk.num_frames;
  const int f0 = x0 / fs, f1 = x1 / fs;
  if (f0 == f1) {
    pmin = (x0 - f0 * fs) * F + f0;
    pmax = (x1 - f1 * fs) * F + f1;
  } else {
    pmin = f0;
    pmax = (fs - 1) * F + f1;
  }
}

template <int KIND>
__device__ __forceinline__ bool mask_allows(const MaskArgs& mk, int qp, int kp) {
  const int d = qp - kp;
  const bool band = d < mk.band_width && d > -mk.band_width;
  if (KIND == KIND_BAND_SINK) return band || kp < mk.sink_size;
  if (KIND == KIND_COG) return band || kp < mk.text_end || qp < mk.text_end;
  if (KIND == KIND_BAND_SINK_PERM) {
    const int pq = perm_pos(mk, qp), pk = perm_pos(mk, kp);
    return (pq - pk < mk.band_width && pk - pq < mk.band_width) || pk < mk.sink_size;
  }
  const bool q_real = qp < mk.text_end, k_real = kp < mk.text_end;
  const bool text_col = kp >= mk.video_len && k_real;
  const bool text_row = qp >= mk.video_len && q_real;
  return (q_real && k_real && (band || text_col || text_row)) || (!q_real && !k_real);
}

constexpr int TILE_NONE = 0, TILE_SOME = 1, TILE_ALL = 2;

// mask_allows over the rectangle [qlo, qhi] x [klo, khi] (inclusive global
// positions): TILE_ALL if it allows every pair, TILE_NONE if it allows none,
// else TILE_SOME (either side may answer TILE_SOME conservatively).
// KIND_BAND_SINK_PERM tests the p-hulls of both ranges (perm_hull): every
// pair lies inside the hulls' rectangle, so band (and sink) all or none on
// the hulls holds for every pair, and TILE_NONE (no band pair, and the
// smallest p of the k hull at or past the sink) never drops a live pair.
template <int KIND>
__device__ __forceinline__ int mask_tile(const MaskArgs& mk, int qlo, int qhi, int klo, int khi) {
  if (KIND == KIND_BAND_SINK_PERM) {
    int pq0, pq1, pk0, pk1;
    perm_hull(mk, qlo, qhi, pq0, pq1);
    perm_hull(mk, klo, khi, pk0, pk1);
    const int w = mk.band_width;
    if ((pq1 - pk0 < w && pk1 - pq0 < w) || pk1 < mk.sink_size) return TILE_ALL;
    if ((pk0 - pq1 >= w || pq0 - pk1 >= w) && pk0 >= mk.sink_size) return TILE_NONE;
    return TILE_SOME;
  }
  const int bw = mk.band_width;
  const bool band_all = qhi - klo < bw && khi - qlo < bw;
  const bool band_none = klo - qhi >= bw || qlo - khi >= bw;
  const int te = mk.text_end;
  bool all, none;
  if (KIND == KIND_BAND_SINK) {
    all = band_all || khi < mk.sink_size;
    none = band_none && klo >= mk.sink_size;
  } else if (KIND == KIND_COG) {
    all = band_all || khi < te || qhi < te;
    none = band_none && klo >= te && qlo >= te;
  } else {
    const int vl = mk.video_len;
    all = (qhi < te && khi < te && (band_all || klo >= vl || qlo >= vl)) || (qlo >= te && klo >= te);
    none = (qhi < te && klo >= te) || (qlo >= te && khi < te) || (qhi < vl && khi < vl && band_none);
  }
  return all ? TILE_ALL : none ? TILE_NONE : TILE_SOME;
}

}  // namespace
