"""Sequential-update splitting over diagnostic components (counterpart of
``tasmania_tpu/framework/splitting.py:101 SequentialUpdateSplitting``).

Each process updates the state in turn.  Only diagnostic components are
ported: a process that needs a time stepper raises ``NotImplementedError``.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Dict, Mapping

from torch import nn

from tasmania_tpu_torch.framework.core_components import DiagnosticComponent
from tasmania_tpu_torch.framework.field import ensure_timedelta_seconds


class SequentialUpdateSplitting(nn.Module):
    def __init__(self, *components: DiagnosticComponent) -> None:
        super().__init__()
        for comp in components:
            if not isinstance(comp, DiagnosticComponent):
                raise NotImplementedError(
                    f"{type(comp).__name__}: only diagnostic components are ported"
                )
        self.components = nn.ModuleList(components)

    def forward(self, state: Mapping[str, Any], timestep) -> Dict[str, Any]:
        out = dict(state)
        for comp in self.components:
            out.update({k: v for k, v in comp(out).items() if k != "time"})
        if "time" in state:
            out["time"] = state["time"] + timedelta(seconds=ensure_timedelta_seconds(timestep))
        return out
