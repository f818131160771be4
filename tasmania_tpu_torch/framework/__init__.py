"""The framework: components, couplings, splittings, steppers, the
registries and stencil dispatch (counterpart of
``tasmania_tpu/framework/__init__.py``, with its 26 names)."""

import tasmania_tpu_torch.framework.stencil_definitions  # noqa: F401  (register generic stencils)
from tasmania_tpu_torch.framework.composite import DiagnosticComponentComposite
from tasmania_tpu_torch.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_tpu_torch.framework.core_components import (
    DiagnosticComponent,
    ImplicitTendencyComponent,
    Stepper,
    TendencyComponent,
)
from tasmania_tpu_torch.framework.dict_operator import DictOperator
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import (
    BackendOptions,
    StorageOptions,
    TimeIntegrationOptions,
)
from tasmania_tpu_torch.framework.promoter import (
    FromDiagnosticToTendency,
    FromTendencyToDiagnostic,
)
from tasmania_tpu_torch.framework.registry import Registry, factor_register, factorize
from tasmania_tpu_torch.framework.splitting import (
    ParallelSplitting,
    SequentialTendencySplitting,
    SequentialUpdateSplitting,
)
from tasmania_tpu_torch.framework.stencil import (
    StencilFactory,
    compile_stencil,
    compile_subroutine,
    stencil_definition,
    subroutine_definition,
)
from tasmania_tpu_torch.framework.steppers import SequentialTendencyStepper, TendencyStepper

__all__ = [
    "DiagnosticComponentComposite",
    "ConcurrentCoupling",
    "DiagnosticComponent",
    "ImplicitTendencyComponent",
    "Stepper",
    "TendencyComponent",
    "DictOperator",
    "FieldArray",
    "BackendOptions",
    "StorageOptions",
    "TimeIntegrationOptions",
    "FromDiagnosticToTendency",
    "FromTendencyToDiagnostic",
    "Registry",
    "factor_register",
    "factorize",
    "ParallelSplitting",
    "SequentialTendencySplitting",
    "SequentialUpdateSplitting",
    "StencilFactory",
    "compile_stencil",
    "compile_subroutine",
    "stencil_definition",
    "subroutine_definition",
    "SequentialTendencyStepper",
    "TendencyStepper",
]
