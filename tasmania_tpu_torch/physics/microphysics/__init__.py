from tasmania_tpu_torch.physics.microphysics.kessler import (
    KesslerFallVelocity,
    KesslerMicrophysics,
    KesslerSaturationAdjustmentDiagnostic,
    KesslerSaturationAdjustmentPrognostic,
    KesslerSedimentation,
)
from tasmania_tpu_torch.physics.microphysics.utils import (
    Clipping,
    Precipitation,
    SedimentationFlux,
)

__all__ = [
    "KesslerFallVelocity",
    "KesslerMicrophysics",
    "KesslerSaturationAdjustmentDiagnostic",
    "KesslerSaturationAdjustmentPrognostic",
    "KesslerSedimentation",
    "Clipping",
    "Precipitation",
    "SedimentationFlux",
]
