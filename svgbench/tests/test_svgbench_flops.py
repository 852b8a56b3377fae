"""The benchmark's work counts against hand counts at small shapes."""

import math

import pytest
import torch

from svgbench import flops
from svgbench.families import wan
from svgbench.reference import svg1 as RS


def brute_pairs(layout, width, temporal=False):
    """The mask's pairs among the live tokens (padding text is not work)."""
    real = layout.vid + layout.prompt if layout.text else layout.seq
    q = torch.arange(real)
    return int(RS.exec_allow(layout, width, temporal)(q[:, None], q[None, :]).sum())


@pytest.mark.parametrize("layout, width", [
    (RS.Layout(nf=5, fs=128), 0.7), (RS.Layout(nf=4, fs=200), 1.9), (RS.Layout(nf=3, fs=96), 0.2),
    (RS.Layout(nf=5, fs=128, text=64, prompt=17), 1.3), (RS.Layout(nf=3, fs=300, text=32, prompt=32), 0.9),
    (RS.Layout(nf=4, fs=256, text=48, prompt=0), 2.2)])
def test_band_pairs_match_the_mask(layout, width):
    n = flops.band_pairs(layout, width)
    assert n == brute_pairs(layout, width)
    assert n == brute_pairs(layout, width, temporal=True)  # a temporal head: the same band, token-major


def test_dense_pairs():
    assert flops.dense_pairs(RS.Layout(nf=3, fs=10)) == 900
    assert flops.dense_pairs(RS.Layout(nf=3, fs=10, text=8, prompt=3)) == 33**2


def test_band_frames_gives_the_sparsity():
    lay = RS.Layout(nf=21, fs=1560)
    w = RS.band_frames(0.25, lay)
    # the band of w frames (before rounding to 128) keeps a quarter of the pairs
    band = w * lay.fs
    kept = lay.seq**2 - (lay.seq - band) ** 2
    assert abs(kept / lay.seq**2 - 0.25) < 1e-12


def test_wan_step_count_by_hand():
    c = {"dim": 64, "ffn_dim": 96, "num_heads": 2, "num_layers": 3, "text_len": 5, "text_dim": 16,
         "freq_dim": 8, "in_dim": 4, "out_dim": 4, "patch_size": [1, 2, 2], "height": 32, "width": 64,
         "num_frames": 5, "first_layers_fp": 0.34}
    S, T, d, B = 2 * 2 * 4, 5, 64, 2  # 2 latent frames of 2 x 4 tokens
    linear = 2 * B * (S * (16 * d + 3 * (4 * d * d + 2 * d * d + 2 * d * 96) + d * 16)
                      + T * (16 * d + d * d + 3 * 2 * d * d) + (8 * d + d * d + 6 * d * d))
    cross = 4 * 32 * 2 * B * 3 * S * T
    dense = wan.counts(c, {"pattern": "dense"})
    assert dense["attn_flops"] == 4 * 32 * 2 * B * 3 * S * S
    assert dense["flops"] == linear + cross + dense["attn_flops"]
    assert dense["attn_bytes"] == 4 * 2 * B * 2 * S * 32 * 3
    svg = wan.counts(c, {"pattern": "SVG", "sparsity": 0.25})
    lay = RS.Layout(nf=2, fs=8)
    pairs = 1 * S * S + 2 * brute_pairs(lay, RS.band_frames(0.25, lay))  # floor(0.34 * 3) = 1 dense layer
    assert svg["attn_flops"] == 4 * 32 * 2 * B * pairs
    assert math.isclose(svg["flops"] - svg["attn_flops"], linear + cross)
