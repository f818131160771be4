"""Namelist of the moist isentropic STS variant (counterpart of
``drivers/namelist_sts.py``): the values of ``namelist_sus.py``, constant for constant.
"""

from __future__ import annotations

from tasmania_tpu_torch.drivers import namelist_sus


def load_namelist(**overrides):
    """A copy of the SUS namelist for this variant, with ``overrides`` applied."""
    return namelist_sus.load_namelist(**overrides)
