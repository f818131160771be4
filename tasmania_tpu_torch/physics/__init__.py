from tasmania_tpu_torch.physics.microphysics import (
    Clipping,
    KesslerFallVelocity,
    KesslerMicrophysics,
    KesslerSaturationAdjustmentDiagnostic,
    KesslerSaturationAdjustmentPrognostic,
    KesslerSedimentation,
    Precipitation,
    SedimentationFlux,
)
from tasmania_tpu_torch.physics.static_energy import DryStaticEnergy, MoistStaticEnergy
from tasmania_tpu_torch.physics.turbulence import Smagorinsky2d

__all__ = [
    "Clipping",
    "KesslerFallVelocity",
    "KesslerMicrophysics",
    "KesslerSaturationAdjustmentDiagnostic",
    "KesslerSaturationAdjustmentPrognostic",
    "KesslerSedimentation",
    "Precipitation",
    "SedimentationFlux",
    "DryStaticEnergy",
    "MoistStaticEnergy",
    "Smagorinsky2d",
]
