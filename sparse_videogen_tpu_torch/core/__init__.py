"""SVG1 algorithm pieces: mask math, the online profiler, placement."""
