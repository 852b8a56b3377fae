"""End-to-end generation pipelines."""

from sparse_videogen_tpu_torch.pipelines.cog import CogPipeline  # noqa: F401
from sparse_videogen_tpu_torch.pipelines.cosmos import CosmosPipeline  # noqa: F401
from sparse_videogen_tpu_torch.pipelines.hyvideo import HyVideoPipeline  # noqa: F401
from sparse_videogen_tpu_torch.pipelines.wan import WanPipeline  # noqa: F401
