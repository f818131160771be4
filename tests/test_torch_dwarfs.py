"""The port's diffusion, hyperdiffusion and smoothing dwarfs (BASELINE
config 2) against the JAX package, on the CPU in float64.

* Each of the six diffusion names, the nine hyperdiffusion names and the
  nine smoothing names on a random 17x15x6 field (nb 3), with the
  coefficient's damped sin² profile over the top levels: within 1e-12 of
  the largest magnitude.  The two-dimensional smoothing filters run
  ``ops/smoothing_step.fused_smoothing``, which on the CPU is the kernel's
  plain version.
* ``IsentropicHorizontalDiffusion`` as a component (dry and moist, with
  coefficients of its own for the water), and ``IsentropicHorizontalSmoothing``
  with a one-dimensional filter, against the JAX components on an
  isentropic state: within 1e-12 of each field's largest magnitude.
"""

from __future__ import annotations

from datetime import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tasmania_tpu.domain import Domain as JaxDomain
from tasmania_tpu.dwarfs import (
    HorizontalDiffusion as JaxDiffusion,
    HorizontalHyperDiffusion as JaxHyperDiffusion,
    HorizontalSmoothing as JaxSmoothing,
)
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.isentropic import get_isentropic_state_from_brunt_vaisala_frequency as jax_state
from tasmania_tpu.isentropic.physics import (
    IsentropicHorizontalDiffusion as JaxIsentropicDiffusion,
    IsentropicHorizontalSmoothing as JaxIsentropicSmoothing,
)
from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.dwarfs.horizontal_diffusion import HorizontalDiffusion
from tasmania_tpu_torch.dwarfs.horizontal_hyperdiffusion import HorizontalHyperDiffusion
from tasmania_tpu_torch.dwarfs.horizontal_smoothing import HorizontalSmoothing
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.framework.registry import registered_names
from tasmania_tpu_torch.isentropic.physics.horizontal_diffusion import IsentropicHorizontalDiffusion
from tasmania_tpu_torch.isentropic.physics.horizontal_smoothing import IsentropicHorizontalSmoothing
from tasmania_tpu_torch.isentropic.state import get_isentropic_state_from_brunt_vaisala_frequency

CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
SHAPE, DX, DY, NB = (17, 15, 6), 1.3e3, 0.9e3, 3
# the coefficient, its maximum and the depth of its sin² ramp
PROFILE = (0.05, 0.2, 4)
TOL = 1e-12


def _assert_close(got, ref, name=""):
    ref = np.asarray(ref)
    scale = np.max(np.abs(ref)) or 1.0
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale, rtol=0, atol=TOL, err_msg=name)


def _field():
    return np.random.default_rng(3).standard_normal(SHAPE)


@pytest.mark.parametrize("name", sorted(registered_names(HorizontalDiffusion)))
def test_diffusion_matches(name):
    phi = _field()
    port = HorizontalDiffusion.factory(name, SHAPE, DX, DY, *PROFILE, NB, storage_options=CPU64)
    ref = JaxDiffusion.factory(name, SHAPE, DX, DY, *PROFILE, NB)
    np.testing.assert_array_equal(port.gamma.numpy(), np.asarray(ref._gamma)[0, 0])
    _assert_close(port(torch.as_tensor(phi)).numpy(), ref(jnp.asarray(phi)), name)


@pytest.mark.parametrize("name", sorted(registered_names(HorizontalHyperDiffusion)))
def test_hyperdiffusion_matches(name):
    phi = _field()
    port = HorizontalHyperDiffusion.factory(name, SHAPE, DX, DY, *PROFILE, NB, storage_options=CPU64)
    ref = JaxHyperDiffusion.factory(name, SHAPE, DX, DY, *PROFILE, NB)
    _assert_close(port(torch.as_tensor(phi)).numpy(), ref(jnp.asarray(phi)), name)


@pytest.mark.parametrize("name", sorted(registered_names(HorizontalSmoothing)))
def test_smoothing_matches(name):
    phi = _field()
    port = HorizontalSmoothing.factory(name, SHAPE, *PROFILE, NB, storage_options=CPU64)
    ref = JaxSmoothing.factory(name, SHAPE, *PROFILE, NB)
    assert port.nb == ref.nb
    _assert_close(port(torch.as_tensor(phi)).numpy(), ref(jnp.asarray(phi)), name)


def _isentropic_pair(nx=19, ny=17, nz=8):
    z = (np.array([400.0, 300.0]), "K", ("z",))
    jd = JaxDomain((0.0, 2e5), nx, (0.0, 1.8e5), ny, JaxFieldArray(*z), nz,
                   horizontal_boundary_type="relaxed", nb=3, horizontal_boundary_kwargs={"nr": 6})
    pd = Domain((0.0, 2e5), nx, (0.0, 1.8e5), ny, FieldArray(*z), nz, horizontal_boundary_type="relaxed",
                nb=3, horizontal_boundary_kwargs={"nr": 6}, storage_options=CPU64)
    args = [(np.asarray(10.0), "m s^-1", ()), (np.asarray(1.0), "m s^-1", ()), (np.asarray(0.01), "s^-1", ())]
    jst = jax_state(jd.numerical_grid, datetime(2000, 1, 1), *(JaxFieldArray(*a) for a in args), moist=True)
    pst = get_isentropic_state_from_brunt_vaisala_frequency(
        pd.numerical_grid, datetime(2000, 1, 1), *(FieldArray(*a) for a in args), moist=True,
        storage_options=CPU64)
    rng = np.random.default_rng(11)
    for name, fa in jst.items():
        if name != "time":
            noisy = np.asarray(fa.data) * (1.0 + 0.05 * rng.standard_normal(fa.shape))
            jst[name] = fa.with_data(jnp.asarray(noisy))
            pst[name] = pst[name].with_data(torch.as_tensor(noisy))
    return jd, pd, jst, pst


@pytest.mark.parametrize("moist", [False, True])
def test_isentropic_diffusion_component_matches(moist):
    jd, pd, jst, pst = _isentropic_pair()
    kw = dict(diffusion_type="fourth_order", diffusion_coeff=5e3, diffusion_coeff_max=2e4,
              diffusion_damp_depth=3, moist=moist, diffusion_moist_coeff=1e3,
              diffusion_moist_coeff_max=4e3, diffusion_moist_damp_depth=2)
    jtends, _ = JaxIsentropicDiffusion(jd, **kw)(jst)
    ptends, pdiags = IsentropicHorizontalDiffusion(pd, storage_options=CPU64, **kw)(pst)
    assert sorted(ptends) == sorted(jtends) and not pdiags
    for name, fa in jtends.items():
        assert ptends[name].units == fa.units
        _assert_close(ptends[name].data.numpy(), fa.data, name)


@pytest.mark.parametrize("smooth_type", ["second_order_1dx", "third_order_1dy"])
def test_isentropic_smoothing_takes_the_1d_filters(smooth_type):
    jd, pd, jst, pst = _isentropic_pair()
    kw = dict(smooth_type=smooth_type, smooth_coeff=0.1, smooth_coeff_max=0.4, smooth_damp_depth=3,
              moist=True, smooth_moist_coeff=0.05)
    jout = JaxIsentropicSmoothing(jd, **kw)(jst)
    pout = IsentropicHorizontalSmoothing(pd, storage_options=CPU64, **kw)(pst)
    assert sorted(pout) == sorted(jout)
    for name, fa in jout.items():
        _assert_close(pout[name].data.numpy(), fa.data, name)
