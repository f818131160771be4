from tasmania_tpu_torch.dwarfs.diagnostics import HorizontalVelocity, WaterConstituent
from tasmania_tpu_torch.dwarfs.horizontal_diffusion import HorizontalDiffusion
from tasmania_tpu_torch.dwarfs.horizontal_hyperdiffusion import HorizontalHyperDiffusion
from tasmania_tpu_torch.dwarfs.horizontal_smoothing import HorizontalSmoothing
from tasmania_tpu_torch.dwarfs.vertical_damping import VerticalDamping

__all__ = [
    "HorizontalVelocity",
    "WaterConstituent",
    "HorizontalDiffusion",
    "HorizontalHyperDiffusion",
    "HorizontalSmoothing",
    "VerticalDamping",
]
