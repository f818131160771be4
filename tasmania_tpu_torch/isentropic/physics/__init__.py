from tasmania_tpu_torch.isentropic.physics.coriolis import IsentropicConservativeCoriolis
from tasmania_tpu_torch.isentropic.physics.diagnostics import (
    IsentropicDiagnostics,
    IsentropicVelocityComponents,
)
from tasmania_tpu_torch.isentropic.physics.horizontal_diffusion import (
    IsentropicHorizontalDiffusion,
)
from tasmania_tpu_torch.isentropic.physics.horizontal_smoothing import (
    IsentropicHorizontalSmoothing,
)
from tasmania_tpu_torch.isentropic.physics.turbulence import IsentropicSmagorinsky
from tasmania_tpu_torch.isentropic.physics.vertical_advection import (
    IsentropicVerticalAdvection,
    PrescribedSurfaceHeating,
)
from tasmania_tpu_torch.isentropic.physics.implicit_vertical_advection import (
    IsentropicImplicitVerticalAdvectionDiagnostic,
    IsentropicImplicitVerticalAdvectionPrognostic,
)
from tasmania_tpu_torch.isentropic.physics.sequential_tendency_stepper import (
    IsentropicVerticalAdvectionSTS,
)

__all__ = [
    "IsentropicConservativeCoriolis",
    "IsentropicDiagnostics",
    "IsentropicVelocityComponents",
    "IsentropicHorizontalDiffusion",
    "IsentropicHorizontalSmoothing",
    "IsentropicSmagorinsky",
    "IsentropicVerticalAdvection",
    "PrescribedSurfaceHeating",
    "IsentropicImplicitVerticalAdvectionDiagnostic",
    "IsentropicImplicitVerticalAdvectionPrognostic",
    "IsentropicVerticalAdvectionSTS",
]
