"""Physical-constants resolution (reference ``src/tasmania/utils/constants.py``).

Defaults are declared as ``{name: (value, units)}``; overrides may supply a
``FieldArray``-like object with units, a ``(value, units)`` pair, or a bare
number (assumed already in default units).  Resolution converts every override
into the default units so components can use plain floats in kernels.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from tasmania_tpu_torch.utils.units import conversion_factor


def get_physical_constants(
    defaults: Mapping[str, Any],
    overrides: Optional[Mapping[str, Any]] = None,
) -> Dict[str, float]:
    """Merge ``overrides`` over ``defaults``, converting to default units."""
    out: Dict[str, float] = {}
    overrides = overrides or {}
    for name, spec in defaults.items():
        if isinstance(spec, tuple):
            default_value, default_units = spec
        else:
            default_value, default_units = float(spec), "1"
        if name in overrides:
            ov = overrides[name]
            if hasattr(ov, "units") and hasattr(ov, "data"):  # FieldArray-like
                value = float(np.asarray(ov.data)) * conversion_factor(
                    ov.units, default_units
                )
            elif isinstance(ov, tuple):
                value = float(ov[0]) * conversion_factor(ov[1], default_units)
            else:
                value = float(ov)
        else:
            value = float(default_value)
        out[name] = value
    return out
