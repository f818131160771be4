"""Stand-in components for tests and composition (counterpart of
``tasmania_tpu/framework/fakes.py``)."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

from tasmania_tpu_torch.framework.core_components import TendencyComponent


class FakeTendencyComponent(TendencyComponent):
    """Takes nothing and gives no tendency and no diagnostic."""

    @property
    def input_properties(self):
        return {}

    @property
    def tendency_properties(self):
        return {}

    @property
    def diagnostic_properties(self):
        return {}

    def array_call(self, state) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        return {}, {}


class FakeComponent:
    """A shell holding another component's property dictionaries under new
    names (``property_names``: new name -> the source's attribute)."""

    def __init__(self, src, property_names: Mapping[str, str]) -> None:
        for trg_name, src_name in property_names.items():
            setattr(self, trg_name, getattr(src, src_name))
