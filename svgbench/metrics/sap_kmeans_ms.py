"""sap_kmeans_ms (ms a step): device time of the program's "sap.kmeans" regions
(utils/timer.py's CUDA events around SAP's kmeans) recorded while the window's
profiler ran, over the window's steps."""

from svgbench.program_spans import region_ms


def read(t):
    return region_ms(t, "sap.kmeans")
