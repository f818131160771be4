"""Namelist of the moist isentropic FC variant (counterpart of
``drivers/namelist_fc.py``): the values of ``namelist_sus.py``, with no
separate physics time-integration scheme (the physics chain runs as one
concurrent coupling).
"""

from __future__ import annotations

from tasmania_tpu_torch.drivers import namelist_sus


def load_namelist(**overrides):
    """A copy of the SUS namelist for this variant, with ``overrides`` applied."""
    return namelist_sus.load_namelist(
        **{"physics_time_integration_scheme": None, **overrides}
    )
