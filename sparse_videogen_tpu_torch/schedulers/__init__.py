"""Samplers (host-side f64 coefficient tables + torch steps)."""

from sparse_videogen_tpu_torch.schedulers.ddim_cog import CogDDIM  # noqa: F401
from sparse_videogen_tpu_torch.schedulers.edm_euler import EDMEuler  # noqa: F401
from sparse_videogen_tpu_torch.schedulers.euler import FlowMatchEuler  # noqa: F401
from sparse_videogen_tpu_torch.schedulers.unipc import FlowUniPC  # noqa: F401
from sparse_videogen_tpu_torch.schedulers.fm_dpm import FlowDPM  # noqa: F401
