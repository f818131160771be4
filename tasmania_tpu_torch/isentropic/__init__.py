from tasmania_tpu_torch.isentropic.dynamics.horizontal_fluxes import (
    IsentropicHorizontalFlux,
    IsentropicMinimalHorizontalFlux,
)
from tasmania_tpu_torch.isentropic.state import (
    get_isentropic_state_from_brunt_vaisala_frequency,
    get_isentropic_state_from_temperature,
)


def __getattr__(name):
    # lazy: the dycore imports the kernel wrappers, which import this package
    if name == "IsentropicDiagnostics":
        from tasmania_tpu_torch.isentropic.dynamics.diagnostics import IsentropicDiagnostics

        return IsentropicDiagnostics
    if name == "IsentropicDynamicalCore":
        from tasmania_tpu_torch.isentropic.dynamics.dycore import IsentropicDynamicalCore

        return IsentropicDynamicalCore
    if name == "IsentropicPrognostic":
        from tasmania_tpu_torch.isentropic.dynamics.prognostic import IsentropicPrognostic

        return IsentropicPrognostic
    raise AttributeError(name)


__all__ = [
    "IsentropicDiagnostics",
    "IsentropicDynamicalCore",
    "IsentropicHorizontalFlux",
    "IsentropicMinimalHorizontalFlux",
    "IsentropicPrognostic",
    "get_isentropic_state_from_brunt_vaisala_frequency",
    "get_isentropic_state_from_temperature",
]
