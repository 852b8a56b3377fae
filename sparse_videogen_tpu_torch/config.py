"""Static configuration objects, shared with the JAX package.

sparse_videogen_tpu/config.py imports only the standard library, so both
packages read this one definition; the port re-exports it here so its
modules and callers import configuration from the port's own tree.
"""

from sparse_videogen_tpu.config import (  # noqa: F401
    SAPConfig,
    SparseMode,
    SVGConfig,
    TextPosition,
    VideoLayout,
    WarmupSchedule,
)
