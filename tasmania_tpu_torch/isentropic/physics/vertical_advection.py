"""Explicit vertical (flux-form) advection for the isentropic model
(counterpart of ``tasmania_tpu/isentropic/physics/vertical_advection.py:34-166``).

The vertical velocity is w = dθ/dt on the main levels, interpolated to the
interfaces; the tendencies of s, su, sv and the three mass fractions (advected
as s·q) are the vertical flux divergence, zero on the ``extent`` top
and bottom levels.  Under RK3WS the stepper takes
``fused_rk_step``: all three stages in
``ops/vertical_advection_step.fused_vertical_advection_rk3ws`` (the kernel on
the card).

``PrescribedSurfaceHeating`` is the analytically prescribed heating from the
surface, plain PyTorch as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tasmania_tpu_torch.framework.core_components import TendencyComponent
from tasmania_tpu_torch.framework.field import FieldArray, get_array_dict
from tasmania_tpu_torch.isentropic.dynamics.vertical_fluxes import IsentropicMinimalVerticalFlux
from tasmania_tpu_torch.ops.vertical_advection_step import fused_vertical_advection_rk3ws
from tasmania_tpu_torch.utils.timer import Timer

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")
DIMS_Z = ("x", "y", "z_on_interface_levels")
TTD = "tendency_of_air_potential_temperature"


def interface_w(w_main):
    """Main-level w on the interfaces; the outermost two are zero."""
    nz = w_main.shape[2]
    w_if = torch.zeros((*w_main.shape[:2], nz + 1), dtype=w_main.dtype, device=w_main.device)
    w_if[:, :, 1:nz] = 0.5 * (w_main[:, :, 1:] + w_main[:, :, :-1])
    return w_if


class IsentropicVerticalAdvection(TendencyComponent):
    fields = ("air_isentropic_density", "x_momentum_isentropic", "y_momentum_isentropic",
              mfwv, mfcw, mfpw)

    def __init__(self, domain, grid_type: str = "numerical", flux_scheme: str = "upwind",
                 **kwargs) -> None:
        super().__init__(domain, grid_type, **kwargs)
        self.vflux = IsentropicMinimalVerticalFlux.factory(flux_scheme, backend=self.backend)
        self.dz = float(np.asarray(self.grid.dz.to_units("K").data))

    @property
    def input_properties(self):
        return {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            TTD: {"dims": DIMS, "units": "K s^-1"},
            mfwv: {"dims": DIMS, "units": "g g^-1"},
            mfcw: {"dims": DIMS, "units": "g g^-1"},
            mfpw: {"dims": DIMS, "units": "g g^-1"},
        }

    @property
    def tendency_properties(self):
        return {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1 s^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            mfwv: {"dims": DIMS, "units": "g g^-1 s^-1"},
            mfcw: {"dims": DIMS, "units": "g g^-1 s^-1"},
            mfpw: {"dims": DIMS, "units": "g g^-1 s^-1"},
        }

    def array_call(self, state):
        e = self.vflux.extent
        s = state["air_isentropic_density"]
        nz = s.shape[2]
        w = interface_w(state[TTD])

        def tendency(phi, scale=None):
            f = self.vflux(0.0, self.dz, w, phi)  # interfaces [e, nz+1-e)
            div = (f[:, :, 1:] - f[:, :, :-1]) / self.dz  # levels [e, nz-e)
            if scale is not None:
                div = div / scale[:, :, e : nz - e]
            out = torch.zeros_like(phi)
            out[:, :, e : nz - e] = div
            return out

        tends = {name: tendency(state[name]) for name in self.fields[:3]}
        for q in self.fields[3:]:
            tends[q] = tendency(s * state[q], scale=s)
        return tends, {}

    def fused_rk_step(self, scheme, state, dt, output_properties):
        """The whole RK3WS step in one operation; None for another scheme."""
        if scheme != "rk3ws":
            return None
        names = self.fields
        with Timer.timing(type(self).__name__):
            raw = get_array_dict(state, self.input_properties)
            stepped = fused_vertical_advection_rk3ws(
                raw[TTD], *(raw[n] for n in names[:3]), tuple(raw[n] for n in names[3:]),
                order=self.vflux.order, dt=float(dt), dz=self.dz,
            )
        return {}, {
            n: FieldArray(a, output_properties[n]["units"], DIMS) for n, a in zip(names, stepped)
        }


class PrescribedSurfaceHeating(TendencyComponent):
    """F = θ·Rd·a/(p·cp)·F0·exp(−a·(z − hs)) within ``characteristic_length``
    of the domain's centre, with the day's amplitudes, attenuation and
    forcing at 12 h, as the JAX package evaluates it; the tendency of θ (on
    the interfaces with ``tendency_of_air_potential_temperature_on_interface_levels``),
    or, with ``tendency_of_air_potential_temperature_in_diagnostics``, the
    diagnostic ``tendency_of_air_potential_temperature``.  The night
    amplitudes, the frequencies' time dependence and ``starting_time`` are
    kept but not read, as there."""

    default_physical_constants = {
        "gas_constant_of_dry_air": (287.05, "J K^-1 kg^-1"),
        "specific_heat_of_dry_air_at_constant_pressure": (1004.0, "J K^-1 kg^-1"),
    }

    def __init__(
        self,
        domain,
        tendency_of_air_potential_temperature_in_diagnostics: bool = False,
        tendency_of_air_potential_temperature_on_interface_levels: bool = False,
        air_pressure_on_interface_levels: bool = True,
        amplitude_at_day_sw=None,
        amplitude_at_day_fw=None,
        amplitude_at_night_sw=None,
        amplitude_at_night_fw=None,
        frequency_sw=None,
        frequency_fw=None,
        attenuation_coefficient_at_day=None,
        attenuation_coefficient_at_night=None,
        characteristic_length=None,
        starting_time=None,
        **kwargs,
    ) -> None:
        super().__init__(domain, "numerical", **kwargs)
        self.in_diags = tendency_of_air_potential_temperature_in_diagnostics
        self.stgz = tendency_of_air_potential_temperature_on_interface_levels
        self.p_stg = air_pressure_on_interface_levels

        def val(x, units, default):
            if isinstance(x, FieldArray):
                return float(np.asarray(x.to_units(units).data))
            return float(x) if x is not None else default

        self.f0d_sw = val(amplitude_at_day_sw, "W m^-2", 800.0)
        self.f0d_fw = val(amplitude_at_day_fw, "W m^-2", 400.0)
        self.f0n_sw = val(amplitude_at_night_sw, "W m^-2", -75.0)
        self.f0n_fw = val(amplitude_at_night_fw, "W m^-2", -37.5)
        self.w_sw = val(frequency_sw, "hr^-1", np.pi / 12.0)
        self.w_fw = val(frequency_fw, "hr^-1", np.pi / 6.0)
        self.ad = val(attenuation_coefficient_at_day, "m^-1", 1.0 / 600.0)
        self.an = val(attenuation_coefficient_at_night, "m^-1", 1.0 / 75.0)
        self.cl = val(characteristic_length, "m", 25000.0)
        self.t0 = starting_time

    @property
    def input_properties(self):
        props = {
            "air_density": {"dims": DIMS, "units": "kg m^-3"},
            "height_on_interface_levels": {"dims": DIMS_Z, "units": "m"},
        }
        if self.p_stg:
            props["air_pressure_on_interface_levels"] = {"dims": DIMS_Z, "units": "Pa"}
        else:
            props["air_pressure"] = {"dims": DIMS, "units": "Pa"}
        return props

    def _output(self):
        name = "air_potential_temperature" + ("_on_interface_levels" if self.stgz else "")
        if self.in_diags:
            name = "tendency_of_" + name
        return {name: {"dims": DIMS_Z if self.stgz else DIMS, "units": "K s^-1"}}

    @property
    def tendency_properties(self):
        return {} if self.in_diags else self._output()

    @property
    def diagnostic_properties(self):
        return self._output() if self.in_diags else {}

    def array_call(self, state):
        g = self.grid
        rd = self.rpc["gas_constant_of_dry_air"]
        cp = self.rpc["specific_heat_of_dry_air_at_constant_pressure"]
        rho = state["air_density"]
        h_if = state["height_on_interface_levels"]
        if self.p_stg:
            p_if = state["air_pressure_on_interface_levels"]
            p = 0.5 * (p_if[:, :, :-1] + p_if[:, :, 1:])
        else:
            p = state["air_pressure"]
        theta = p * 0.0 + torch.as_tensor(
            np.asarray(g.z.to_units("K").data)[np.newaxis, np.newaxis, :], dtype=rho.dtype,
            device=rho.device)
        z = 0.5 * (h_if[:, :, :-1] + h_if[:, :, 1:])
        hs = h_if[:, :, -1:]
        xv = np.asarray(g.x.to_units("m").data)
        yv = np.asarray(g.y.to_units("m").data)
        cx, cy = 0.5 * (xv[0] + xv[-1]), 0.5 * (yv[0] + yv[-1])
        r = torch.as_tensor(np.sqrt((xv[:, None] - cx) ** 2 + (yv[None, :] - cy) ** 2)[:, :, None],
                            dtype=rho.dtype, device=rho.device)
        cutoff = torch.where(r < self.cl, 1.0, 0.0).to(rho.dtype)
        a, t_hours = self.ad, 12.0
        forcing = self.f0d_sw * math.sin(self.w_sw * t_hours) + self.f0d_fw * math.sin(self.w_fw * t_hours)
        heating = theta * rd * a / (p * cp) * forcing * torch.exp(-a * (z - hs)) * cutoff
        (name,) = self._output()
        return ({}, {name: heating}) if self.in_diags else ({name: heating}, {})
