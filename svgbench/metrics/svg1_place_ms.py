"""svg1_place_ms (ms a step): device time of the program's "svg1.place" regions
(utils/timer.py's CUDA events around SVG1's placement, place_heads of q, k
and v and its inverse on o (dual_rows in the in-place mode)) recorded while
the window's profiler ran, over the window's steps."""

from svgbench.program_spans import region_ms


def read(t):
    return region_ms(t, "svg1.place")
