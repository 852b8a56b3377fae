"""svg1_profile_ms (ms a step): device time of the program's "svg1.profile"
regions (utils/timer.py's CUDA events around SVG1's profiler, sample_mse and
best_mask_idx) recorded while the window's profiler ran, over the window's
steps."""

from svgbench.program_spans import region_ms


def read(t):
    return region_ms(t, "svg1.profile")
