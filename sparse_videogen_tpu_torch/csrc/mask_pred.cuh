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
// Kind none never calls it (it runs the band_sink instance without the
// predicate). The kind is a template parameter so that the band_sink
// kernels carry no registers for the text kinds' scalars. KIND_BAND_SINK_PERM
// (band_sink at the permuted positions p(x) = (x % frame_size) * num_frames
// + x / frame_size) names the dual per-head spec of placement-free SVG1 at
// the C entry; its temporal heads run KIND_BAND_SINK on p (MODE_SLAB of
// csrc/hopper_attn.cuh), its spatial ones KIND_BAND_SINK.

#pragma once

namespace {

constexpr int KIND_BAND_SINK = 1;
constexpr int KIND_HYVIDEO = 2;
constexpr int KIND_COG = 3;
constexpr int KIND_BAND_SINK_PERM = 4;

struct MaskArgs {
  int band_width, sink_size, video_len, text_end;
};

template <int KIND>
__device__ __forceinline__ bool mask_allows(const MaskArgs& mk, int qp, int kp) {
  const int d = qp - kp;
  const bool band = d < mk.band_width && d > -mk.band_width;
  if (KIND == KIND_BAND_SINK) return band || kp < mk.sink_size;
  if (KIND == KIND_COG) return band || kp < mk.text_end || qp < mk.text_end;
  const bool q_real = qp < mk.text_end, k_real = kp < mk.text_end;
  const bool text_col = kp >= mk.video_len && k_real;
  const bool text_row = qp >= mk.video_len && q_real;
  return (q_real && k_real && (band || text_col || text_row)) || (!q_real && !k_real);
}

constexpr int TILE_NONE = 0, TILE_SOME = 1, TILE_ALL = 2;

// mask_allows over the rectangle [qlo, qhi] x [klo, khi] (inclusive global
// positions): TILE_ALL if it allows every pair, TILE_NONE if it allows none,
// else TILE_SOME (either side may answer TILE_SOME conservatively).
template <int KIND>
__device__ __forceinline__ int mask_tile(const MaskArgs& mk, int qlo, int qhi, int klo, int khi) {
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
