"""SVG1 plan and the dense/SVG1 self-attention runtimes."""
