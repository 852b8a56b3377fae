"""The port's logger (counterpart of sparse_videogen_tpu/utils/logging.py):
the "sparse_videogen_tpu_torch" logger to stderr, its level from
$SVT_LOG_LEVEL (default INFO)."""

import logging
import os
import sys

logger = logging.getLogger("sparse_videogen_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | svt | %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("SVT_LOG_LEVEL", "INFO"))
