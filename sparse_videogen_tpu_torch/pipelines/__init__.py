"""End-to-end generation pipelines."""

from sparse_videogen_tpu_torch.pipelines.wan import WanPipeline  # noqa: F401
