"""The plain reference of the moist isentropic model under sequential-update
splitting (``sus``) and full concurrent coupling (``fc``): a frozen copy of
the algebra of ``tasmania_tpu_torch``'s plain PyTorch path for these two
couplings, restated as functions on dicts of tensors.  It imports only
``torch`` and the standard library, and takes nothing the program made: from
the namelist values of a configuration file it works out the grid, the
topography, the relaxation coefficients, the Rayleigh profile, the balanced
base state (also the lateral boundary's reference state) and the top
pressure; from a perturbation it forms a forecast's initial state.

One step, with ``hs`` the mountain's height at that step:

* the dycore: three RK3WS-SI stages of dt/3, dt/2 and dt from the "now"
  fields, each the fifth-order upwind advection of the density and the
  water densities, the relaxed lateral boundary on the density, its
  Montgomery potential, the momenta with the off-centred pressure gradient,
  then the mass fractions, the boundary on every field and, on the last
  stage, Rayleigh damping toward the reference; the staggered velocities of
  each stage's output, their outermost faces from the reference;
* ``sus``: the physics in turn: the isentropic diagnostics, the second-order
  Shapiro smoothing, Smagorinsky (RK2), the velocities, Kessler and
  saturation adjustment (each RK2, the second on the first's output, with
  the temperature held), third-order vertical advection (RK3WS) with the
  θ-tendency as the vertical velocity, sedimentation (RK3WS, the fall
  velocity of its first stage) and the surface precipitation;
* ``fc``: the physics chain [Smagorinsky, Kessler, saturation adjustment,
  vertical advection, fall velocity, sedimentation] as tendencies on each
  stage's input, the diagnostics after each stage, and after the step the
  fall velocity, the precipitation, the smoothing and the velocities.

Every function computes in the dtype of its inputs: ``Reference(nl,
device, dtype)`` casts what it derives from the namelist to ``dtype`` and
steps in it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

Fields = Dict[str, torch.Tensor]

# physical constants (SI)
RD = 287.05  # gas constant of dry air
RV = 461.52  # gas constant of water vapour
G = 9.80665  # gravitational acceleration
PREF = 1.0e5  # reference pressure
CP = 1004.0  # specific heat of dry air at constant pressure
LHVW = 2.5e6  # latent heat of vaporisation of water
RHOW = 1000.0  # density of liquid water

#: the stage fractions of RK3WS-SI
STAGES = (1.0 / 3.0, 0.5, 1.0)
#: the namelist's choices of scheme this reference implements, and no other
FIXED = {
    "hb_type": "relaxed",
    "time_integration_scheme": "rk3ws_si",
    "horizontal_flux_scheme": "fifth_order_upwind",
    "vertical_flux_scheme": "third_order_upwind",
    "vertical_advection": True,
    "implicit_vertical_advection": False,
    "damp_type": "rayleigh",
    "damp": True,
    "damp_at_every_stage": False,
    "smooth_type": "second_order",
    "smooth": True,
    "smooth_moist": True,
    "coriolis_parameter": None,
    "sedimentation": True,
    "sedimentation_flux_scheme": "second_order_upwind",
    "sedimentation_vt_mode": "step",
    "process_merges": [],
}


# -- grid, boundary and profiles ------------------------------------------------


def relaxation_ramp(nr: int, nb: int):
    rel = [1.0 - math.tanh(0.5 * i) for i in range(8)][:nr]
    return [1.0] * nb + rel[nb:]


def relaxation_coefficients(nx: int, ny: int, nb: int, nr: int) -> torch.Tensor:
    """γ (nx+1, ny+1) of the relaxed lateral boundary: the ramp over the nr
    outermost layers of each edge, the corners by the nearer edge, the
    outermost staggered row and column pinned to the reference."""
    rel = torch.tensor(relaxation_ramp(nr, nb), dtype=torch.float64)
    i = torch.arange(nx + 1)
    j = torch.arange(ny + 1)
    di = torch.minimum(i, nx - 1 - i)  # layers from the nearer x edge
    dj = torch.minimum(j, ny - 1 - j)
    d = torch.minimum(di[:, None], dj[None, :])
    g = torch.where(d < nr, rel[d.clamp(0, nr - 1)], torch.zeros((), dtype=torch.float64))
    g[nx, :] = 1.0
    g[:, ny] = 1.0
    return g


def enforce(phi, gamma, ref):
    """The relaxed boundary: ``ref`` where γ = 1, ``phi`` where γ = 0, the
    lerp between."""
    return torch.where(gamma == 0.0, phi, torch.where(gamma == 1.0, ref, phi - gamma * (phi - ref)))


def clip(x):
    return torch.where(x > 0.0, x, torch.zeros_like(x))


def tetens(t):
    return 610.78 * torch.exp(17.27 * (t - 273.16) / (t - 35.86))


class Reference:
    """The model of one configuration: its grid and profiles, the base state
    and the step of its coupling.  ``nl`` holds the configuration file's
    ``namelist``."""

    def __init__(self, nl: dict, device="cpu", dtype=torch.float64) -> None:
        self.nl = nl
        self.device = torch.device(device)
        self.dtype = dtype
        self.coupling = nl["coupling"]
        if self.coupling not in ("sus", "fc"):
            raise ValueError(f"the reference runs sus and fc, not {self.coupling!r}")
        fixed = dict(FIXED, physics_time_integration_scheme="rk2" if self.coupling == "sus" else None)
        differ = sorted(k for k, v in fixed.items() if nl.get(k) != v)
        if nl["topography"].get("type") != "gaussian":
            differ.append("topography.type")
        if differ:
            raise ValueError(f"the reference implements {fixed}; the namelist differs in {differ}")
        f64 = dict(dtype=torch.float64)
        nx, ny, nz = nl["nx"], nl["ny"], nl["nz"]
        self.nx, self.ny, self.nz, self.nb = nx, ny, nz, nl["nb"]
        x = torch.linspace(nl["domain_x_m"][0], nl["domain_x_m"][1], nx, **f64)
        y = torch.linspace(nl["domain_y_m"][0], nl["domain_y_m"][1], ny, **f64)
        self.dx = (nl["domain_x_m"][1] - nl["domain_x_m"][0]) / (nx - 1)
        self.dy = (nl["domain_y_m"][1] - nl["domain_y_m"][0]) / (ny - 1)
        th_top, th_bottom = nl["domain_z_K"]
        theta_if = torch.linspace(th_top, th_bottom, nz + 1, **f64)
        theta = 0.5 * (theta_if[:-1] + theta_if[1:])
        self.dz = abs(th_top - th_bottom) / nz
        self.dt = float(nl["timestep_s"])
        self.eps = float(nl["eps"])
        # the Gaussian mountain at full height; it grows linearly over topo_time_s
        topo = nl["topography"]
        cx, cy = 0.5 * (x[0] + x[-1]), 0.5 * (y[0] + y[-1])
        self.hs_steady64 = topo["max_height_m"] * torch.exp(
            -(((x[:, None] - cx) / topo["width_x_m"]) ** 2) - ((y[None, :] - cy) / topo["width_y_m"]) ** 2)
        self.topo_time = float(topo["time_s"])
        # Rayleigh damping over the top damp_depth levels (a cosine ramp)
        depth = min(nl["damp_depth"], nz)
        za, zt = float(theta[depth - 1]), float(theta_if[0])
        rmat = (theta >= za) * nl["damp_max"] * (1.0 - torch.cos(math.pi * (theta - za) / (zt - za)))
        # the smoothing coefficient of each level: sin² ramp to its maximum
        self.smooth_gamma = torch.stack([
            self._smoothing_profile(nz, nl["smooth_coeff"], nl["smooth_coeff_max"], nl["smooth_damp_depth"]),
            self._smoothing_profile(nz, nl["smooth_moist_coeff"], nl["smooth_moist_coeff_max"],
                                    nl["smooth_moist_damp_depth"]),
        ])
        gamma = relaxation_coefficients(nx, ny, self.nb, nl["nr"])
        cast = dict(device=self.device, dtype=dtype)
        self.theta_if = theta_if.to(**cast)
        self.rmat = rmat.to(**cast)
        self.damps = bool((rmat > 0).any())
        self.smooth_gamma = self.smooth_gamma.to(**cast)
        self.gamma_c = gamma[:nx, :ny, None].to(**cast)
        self.gamma_u = gamma[: nx + 1, :ny, None].to(**cast)
        self.gamma_v = gamma[:nx, : ny + 1, None].to(**cast)
        self.hs_steady = self.hs_steady64.to(**cast)
        base, self.pt = self._base_state(x, y, theta_if, theta)
        self.base = {k: v.to(**cast) for k, v in base.items()}
        mp = nl["microphysics"]
        self.a, self.k1, self.k2 = mp["autoconversion_threshold"], mp["autoconversion_rate"], mp["collection_rate"]
        self.sr = mp["saturation_rate"]
        self.cs = nl["smagorinsky_constant"]

    @staticmethod
    def _smoothing_profile(nz, coeff, coeff_max, depth):
        g = torch.full((nz,), float(coeff), dtype=torch.float64)
        n = min(depth, nz)
        if n > 0:
            k = torch.arange(n, dtype=torch.float64)
            g[:n] += (coeff_max - coeff) * torch.sin(0.5 * math.pi * (n - k) / n) ** 2
        return g

    def _base_state(self, x, y, theta_if, theta):
        """The balanced state of a uniform Brunt-Väisälä frequency with the
        mountain at its initial height (none: it grows from zero), in
        float64; and the top pressure."""
        nl = self.nl
        nx, ny, nz, dz = self.nx, self.ny, self.nz, self.dz
        f64 = dict(dtype=torch.float64)
        hs = torch.zeros(nx, ny, **f64)
        bv2 = nl["brunt_vaisala_s-1"] ** 2
        dh = G * dz / (bv2 * theta)
        h = torch.cat([hs[:, :, None] + torch.flip(torch.cumsum(torch.flip(dh, [0]), 0), [0]), hs[:, :, None]], 2)
        dexn = dz * G**2 / (bv2 * theta**2)
        exn1 = torch.cat([CP - torch.flip(torch.cumsum(torch.flip(dexn, [0]), 0), [0]),
                          torch.tensor([CP], **f64)])
        exn = exn1.expand(nx, ny, nz + 1).clone()
        p = PREF * (exn / CP) ** (CP / RD)
        base = G * h[:, :, nz] + theta_if[nz] * exn[:, :, nz] + 0.5 * dz * exn[:, :, nz]
        inc = dz * exn[:, :, 1:nz]
        mtg = torch.cat([base[:, :, None] + torch.flip(torch.cumsum(torch.flip(inc, [2]), 2), [2]),
                         base[:, :, None]], 2)
        s = (p[:, :, 1:] - p[:, :, :-1]) / (G * dz)
        u = torch.full((nx + 1, ny, nz), float(nl["x_velocity_m_s"]), **f64)
        v = torch.full((nx, ny + 1, nz), float(nl["y_velocity_m_s"]), **f64)
        su = 0.5 * s * (u[:-1] + u[1:])
        sv = 0.5 * s * (v[:, :-1] + v[:, 1:])
        rho = s * dz / (h[:, :, :-1] - h[:, :, 1:])
        t = 0.5 * (exn[:, :, :-1] + exn[:, :, 1:]) * theta / CP
        p_main = 0.5 * (p[:, :, :-1] + p[:, :, 1:])
        p_sat = tetens(t)
        pw = nl["relative_humidity"] * p_sat
        qv = torch.where(p_sat >= 0.616 * p_main, torch.zeros_like(t), 0.62198 * pw / (p_main - pw))
        zero = torch.zeros_like(s)
        plane = torch.zeros(nx, ny, 1, **f64)
        state = dict(s=s, su=su, sv=sv, u=u, v=v, mtg=mtg, p=p, exn=exn, h=h, rho=rho, t=t, qv=qv,
                     qc=zero, qr=zero.clone(), ttd=zero.clone(), prec=plane, accprec=plane.clone())
        return state, float(p[0, 0, 0])

    # -- a forecast -----------------------------------------------------------------

    def initial_state(self, du, dv, rq) -> Fields:
        """The base state with the perturbation of a forecast: ``du`` (nx+1,
        ny, nz) and ``dv`` (nx, ny+1, nz) added to the staggered velocities,
        the momenta formed from them, and the water vapour times 1 + ``rq``."""
        b = self.base
        cast = dict(device=self.device, dtype=self.dtype)
        st = dict(b)
        st["u"] = b["u"] + du.to(**cast)
        st["v"] = b["v"] + dv.to(**cast)
        st["su"] = 0.5 * b["s"] * (st["u"][:-1] + st["u"][1:])
        st["sv"] = 0.5 * b["s"] * (st["v"][:, :-1] + st["v"][:, 1:])
        st["qv"] = b["qv"] * (1.0 + rq.to(**cast))
        return st

    def fact(self, i: int) -> float:
        """The mountain's share of its height at step ``i`` (from 0)."""
        return min((i + 1) * self.dt / self.topo_time, 1.0)

    def forecast(self, state: Fields, steps: int) -> Fields:
        for i in range(steps):
            state = self.step(state, self.fact(i) * self.hs_steady)
        return state

    def step(self, st: Fields, hs) -> Fields:
        return self.step_sus(st, hs) if self.coupling == "sus" else self.step_fc(st, hs)

    # -- stencils ---------------------------------------------------------------------

    def inner(self, a):
        nb = self.nb
        return a[nb : a.shape[0] - nb, nb : a.shape[1] - nb]

    def with_inner(self, base, interior):
        out = base.clone()
        self.inner(out)[...] = interior
        return out

    def divergence(self, u, v, phi):
        """The divergence of the fifth-order upwind fluxes of ``phi`` on the
        nb-inset interior."""
        nb = self.nb
        nx, ny = phi.shape[0], phi.shape[1]
        jin, iin = slice(nb, ny - nb), slice(nb, nx - nb)

        def flux(w, pm3, pm2, pm1, p0, pp1, pp2):
            return w / 60.0 * (37.0 * (p0 + pm1) - 8.0 * (pp1 + pm2) + (pp2 + pm3)) - torch.abs(w) / 60.0 * (
                10.0 * (p0 - pm1) - 5.0 * (pp1 - pm2) + (pp2 - pm3))

        fx = flux(u[nb : nx - nb + 1, jin], *[phi[nb - 3 + k : nx - nb - 2 + k, jin] for k in range(6)])
        fy = flux(v[iin, nb : ny - nb + 1], *[phi[iin, nb - 3 + k : ny - nb - 2 + k] for k in range(6)])
        return (fx[1:] - fx[:-1]) / self.dx + (fy[:, 1:] - fy[:, :-1]) / self.dy

    def diagnostics(self, s, hs):
        """Pressure, Exner function, Montgomery potential, height (the
        interfaces but the potential), density and temperature of ``s``."""
        p = torch.cat([torch.zeros_like(s[:, :, :1]), torch.cumsum(G * self.dz * s, 2)], 2) + self.pt
        exn = CP * (p / PREF) ** (RD / CP)
        mtg = self.montgomery_of(exn, hs)
        th = self.theta_if
        dh = RD * (th[:-1] * exn[:, :, :-1] + th[1:] * exn[:, :, 1:]) * (p[:, :, :-1] - p[:, :, 1:]) / (
            CP * G * (p[:, :, :-1] + p[:, :, 1:]))
        hs3 = hs[:, :, None]
        h = torch.cat([hs3 - torch.flip(torch.cumsum(torch.flip(dh, [2]), 2), [2]), hs3], 2)
        rho = s * (th[:-1] - th[1:]) / (h[:, :, :-1] - h[:, :, 1:])
        t = 0.5 / CP * (th[:-1] * exn[:, :, :-1] + th[1:] * exn[:, :, 1:])
        return dict(p=p, exn=exn, mtg=mtg, h=h, rho=rho, t=t)

    def montgomery_of(self, exn, hs):
        nz = exn.shape[2] - 1
        base = self.theta_if[nz] * exn[:, :, nz:] + G * hs[:, :, None] + 0.5 * self.dz * exn[:, :, nz:]
        inc = self.dz * exn[:, :, 1:nz]
        return torch.cat([base + torch.flip(torch.cumsum(torch.flip(inc, [2]), 2), [2]), base], 2)

    def montgomery(self, s, hs):
        p = torch.cat([torch.zeros_like(s[:, :, :1]), torch.cumsum(G * self.dz * s, 2)], 2) + self.pt
        return self.montgomery_of(CP * (p / PREF) ** (RD / CP), hs)

    def velocities(self, s, su, sv):
        """The staggered velocities of the momenta, the outermost faces the
        reference's."""
        u = self.base["u"].clone()
        v = self.base["v"].clone()
        u[1:-1] = (su[:-1] + su[1:]) / (s[:-1] + s[1:])
        v[:, 1:-1] = (sv[:, :-1] + sv[:, 1:]) / (s[:, :-1] + s[:, 1:])
        return u, v

    # -- the dycore ---------------------------------------------------------------------

    def stage(self, k: int, now: Fields, st: Fields, hs, tend: Optional[Fields] = None) -> Fields:
        """Stage ``k`` of RK3WS-SI from the "now" fields, the stage's input
        ``st`` and, with ``tend``, the tendencies of s, su, sv and the mass
        fractions (any may be missing)."""
        tend = tend or {}
        dt = STAGES[k] * self.dt
        b, gc = self.base, self.gamma_c
        u, v = st["u"], st["v"]
        div = lambda phi: self.divergence(u, v, phi)  # noqa: E731

        def rhs(phi, name, scale=None):
            r = div(phi)
            if name in tend:
                t = tend[name] if scale is None else scale * tend[name]
                r = r - self.inner(t)
            return r

        s_res = self.with_inner(now["s"], self.inner(now["s"]) - dt * rhs(st["s"], "s"))
        s_e = enforce(s_res, gc, b["s"])
        mtg = self.montgomery(s_e, hs)
        nb, eps = self.nb, self.eps
        nx, ny = s_e.shape[0], s_e.shape[1]
        iin, jin = slice(nb, nx - nb), slice(nb, ny - nb)
        ip, im = slice(nb + 1, nx - nb + 1), slice(nb - 1, nx - nb - 1)
        jp, jm = slice(nb + 1, ny - nb + 1), slice(nb - 1, ny - nb - 1)
        sn, se, mn = now["s"][iin, jin], s_e[iin, jin], now["mtg"]
        pgx = (1.0 - eps) * sn * (mn[ip, jin] - mn[im, jin]) / (2.0 * self.dx) + eps * se * (
            mtg[ip, jin] - mtg[im, jin]) / (2.0 * self.dx)
        pgy = (1.0 - eps) * sn * (mn[iin, jp] - mn[iin, jm]) / (2.0 * self.dy) + eps * se * (
            mtg[iin, jp] - mtg[iin, jm]) / (2.0 * self.dy)
        su = self.with_inner(now["su"], self.inner(now["su"]) - dt * (rhs(st["su"], "su") + pgx))
        sv = self.with_inner(now["sv"], self.inner(now["sv"]) - dt * (rhs(st["sv"], "sv") + pgy))
        damp = k == len(STAGES) - 1 and self.damps

        def damped(phi, name):
            phi = enforce(phi, gc, b[name])
            return phi - self.dt * self.rmat * (now[name] - b[name]) if damp else phi

        out = dict(s=damped(s_e, "s"), su=damped(su, "su"), sv=damped(sv, "sv"))
        for q in ("qv", "qc", "qr"):
            sq_now = clip(now["s"] * now[q])
            sq = self.with_inner(sq_now, self.inner(sq_now) - dt * rhs(clip(st["s"] * st[q]), q, st["s"]))
            out[q] = enforce(clip(sq / s_e), gc, b[q])
        out["u"], out["v"] = self.velocities(out["s"], out["su"], out["sv"])
        return out

    # -- the physics ----------------------------------------------------------------------

    def smoothing(self, fields):
        """Second-order Shapiro smoothing of s, su, sv (the first
        coefficient profile) and the mass fractions (the second)."""
        out = []
        for f, phi in enumerate(fields):
            g = self.smooth_gamma[0 if f < 3 else 1]
            nb = self.nb
            nx, ny = phi.shape[0], phi.shape[1]
            iin, jin = slice(nb, nx - nb), slice(nb, ny - nb)
            acc = (1.0 - 0.75 * g) * phi[iin, jin]
            for off, wt in ((-2, -0.0625), (-1, 0.25), (1, 0.25), (2, -0.0625)):
                acc = acc + wt * g * phi[nb + off : nx - nb + off, jin] + wt * g * phi[iin, nb + off : ny - nb + off]
            out.append(self.with_inner(phi, acc))
        return out

    def smagorinsky(self, s, su, sv):
        """The Smagorinsky tendencies of the momenta on the nb-inset
        interior."""
        u, v = su / s, sv / s
        nb, dx, dy = self.nb, self.dx, self.dy
        ib, ie, jb, je = nb, u.shape[0] - nb, nb, u.shape[1] - nb
        s00 = (u[ib : ie + 2, jb - 1 : je + 1] - u[ib - 2 : ie, jb - 1 : je + 1]) / (2.0 * dx)
        s01 = 0.5 * ((u[ib - 1 : ie + 1, jb : je + 2] - u[ib - 1 : ie + 1, jb - 2 : je]) / (2.0 * dy)
                     + (v[ib : ie + 2, jb - 1 : je + 1] - v[ib - 2 : ie, jb - 1 : je + 1]) / (2.0 * dx))
        s11 = (v[ib - 1 : ie + 1, jb : je + 2] - v[ib - 1 : ie + 1, jb - 2 : je]) / (2.0 * dy)
        nu = self.cs**2 * dx * dy * (2.0 * (s00**2 + 2.0 * s01**2 + s11**2)) ** 0.5
        ut = 2.0 * ((nu[2:, 1:-1] * s00[2:, 1:-1] - nu[:-2, 1:-1] * s00[:-2, 1:-1]) / (2.0 * dx)
                    + (nu[1:-1, 2:] * s01[1:-1, 2:] - nu[1:-1, :-2] * s01[1:-1, :-2]) / (2.0 * dy))
        vt = 2.0 * ((nu[2:, 1:-1] * s01[2:, 1:-1] - nu[:-2, 1:-1] * s01[:-2, 1:-1]) / (2.0 * dx)
                    + (nu[1:-1, 2:] * s11[1:-1, 2:] - nu[1:-1, :-2] * s11[1:-1, :-2]) / (2.0 * dy))
        s_in = self.inner(s)
        return s_in * ut, s_in * vt

    def saturation(self, d: Fields):
        """The Exner function on the main levels and the saturation mixing
        ratio, from the diagnostics ``d``."""
        p = 0.5 * (d["p"][:, :, :-1] + d["p"][:, :, 1:])
        exn = 0.5 * (d["exn"][:, :, :-1] + d["exn"][:, :, 1:])
        return exn, (RD / RV) * tetens(d["t"]) / p

    def kessler_tendencies(self, rho, qvs, qv, qc, qr):
        """(qv, qc, qr) tendencies of autoconversion, accretion and rain
        evaporation."""
        zero = torch.zeros((), dtype=qv.dtype, device=qv.device)
        ar = self.k1 * torch.where(qc > self.a, qc - self.a, zero)
        cr = self.k2 * qc * torch.where(qr > 0.0, qr**0.875, zero)
        er = torch.where(qr > 0.0, 0.0484794 * (qvs - qv) * (rho * qr) ** 0.65, zero)
        return er, -(ar + cr), ar + cr - er

    def adjustment(self, t, qvs, qv, qc):
        """The condensation of the relaxed saturation adjustment (positive:
        evaporation), before its rate."""
        sat = (qvs - qv) / (1.0 + qvs * LHVW**2 / (CP * RV * t**2))
        return torch.where(sat <= qc, sat, qc)

    def vertical_tendency(self, w, phi, scale=None):
        """The third-order upwind vertical flux divergence of ``phi`` with
        the main-level velocity ``w`` on the interfaces; zero on the two
        top and bottom levels; divided by ``scale`` where given."""
        nz = phi.shape[2]
        wf = 0.5 * (w[:, :, 1 : nz - 2] + w[:, :, 2 : nz - 1])
        f = wf / 12.0 * (7.0 * (phi[:, :, 1:-2] + phi[:, :, 2:-1]) - (phi[:, :, :-3] + phi[:, :, 3:])) - (
            wf.abs() / 12.0 * (3.0 * (phi[:, :, 1:-2] - phi[:, :, 2:-1]) - (phi[:, :, :-3] - phi[:, :, 3:])))
        div = (f[:, :, 1:] - f[:, :, :-1]) / self.dz
        if scale is not None:
            div = div / scale[:, :, 2 : nz - 2]
        out = torch.zeros_like(phi)
        out[:, :, 2 : nz - 2] = div
        return out

    def fall_velocity(self, rho, qr):
        return 36.34 * (1.0e-3 * rho * clip(qr)) ** 0.1346 * (rho[:, :, -1:] / rho) ** 0.5

    def sedimentation_tendency(self, rho, h_if, qr, vt):
        """The qr tendency of the second-order upwind sedimentation flux,
        zero on the two top levels."""
        h = 0.5 * (h_if[:, :, :-1] + h_if[:, :, 1:])
        h0, h1, h2 = h[:, :, :-2], h[:, :, 1:-1], h[:, :, 2:]
        a = (2.0 * h2 - h1 - h0) / ((h1 - h2) * (h0 - h2))
        b = (h0 - h2) / ((h1 - h2) * (h0 - h1))
        c = (h2 - h1) / ((h0 - h2) * (h0 - h1))
        f = rho * qr * vt
        out = torch.zeros_like(qr)
        out[:, :, 2:] = (a * f[:, :, 2:] + b * f[:, :, 1:-1] + c * f[:, :, :-2]) / rho[:, :, 2:]
        return out

    def precipitation(self, rho, qr, vt, acc, dt):
        prec = 3.6e6 * rho[:, :, -1:] * qr[:, :, -1:] * vt[:, :, -1:] / RHOW
        return prec, acc + dt * prec / 3.6e3

    # -- the couplings ----------------------------------------------------------------------

    def step_sus(self, st: Fields, hs) -> Fields:
        dt = self.dt
        out = dict(st)
        cur = st
        for k in range(len(STAGES)):
            cur = self.stage(k, st, cur, hs)
        out.update(cur)
        # the diagnostics
        d = self.diagnostics(out["s"], hs)
        out.update(d)
        # smoothing
        names = ("s", "su", "sv", "qv", "qc", "qr")
        out.update(zip(names, self.smoothing([out[n] for n in names])))
        # Smagorinsky, RK2
        s, su0, sv0 = out["s"], out["su"], out["sv"]
        ut, vt = self.smagorinsky(s, su0, sv0)
        su1 = self.with_inner(su0, self.inner(su0) + 0.5 * dt * ut)
        sv1 = self.with_inner(sv0, self.inner(sv0) + 0.5 * dt * vt)
        ut, vt = self.smagorinsky(s, su1, sv1)
        out["su"] = self.with_inner(su0, self.inner(su0) + dt * ut)
        out["sv"] = self.with_inner(sv0, self.inner(sv0) + dt * vt)
        out["u"], out["v"] = self.velocities(out["s"], out["su"], out["sv"])
        # Kessler, RK2, then saturation adjustment, RK2, the temperature held
        exn, qvs = self.saturation(d)
        qv, qc, qr = out["qv"], out["qc"], out["qr"]
        ev1, ec1, er1 = self.kessler_tendencies(d["rho"], qvs, qv, qc, qr)
        h = 0.5 * dt
        ev2, ec2, er2 = self.kessler_tendencies(d["rho"], qvs, qv + h * ev1, qc + h * ec1, qr + h * er1)
        qv, qc, qr = qv + dt * ev2, qc + dt * ec2, qr + dt * er2
        ttd = -LHVW / exn * ev1
        d1 = self.adjustment(d["t"], qvs, qv, qc)
        hsr = 0.5 * dt * self.sr
        d2 = self.adjustment(d["t"], qvs, qv + hsr * d1, qc - hsr * d1)
        qv, qc = qv + dt * self.sr * d2, qc - dt * self.sr * d2
        out["ttd"] = ttd - self.sr * (LHVW / exn) * d1
        # vertical advection, RK3WS
        w = out["ttd"]
        x0 = dict(s=out["s"], su=out["su"], sv=out["sv"], qv=qv, qc=qc, qr=qr)
        x = x0
        for c in (dt / 3.0, dt / 2.0, dt):
            x = dict(
                s=x0["s"] + c * self.vertical_tendency(w, x["s"]),
                su=x0["su"] + c * self.vertical_tendency(w, x["su"]),
                sv=x0["sv"] + c * self.vertical_tendency(w, x["sv"]),
                **{q: x0[q] + c * self.vertical_tendency(w, x["s"] * x[q], x["s"]) for q in ("qv", "qc", "qr")},
            )
        out.update(x)
        # sedimentation, RK3WS, the fall velocity of the first stage
        rho, qr0 = d["rho"], out["qr"]
        vt1 = self.fall_velocity(rho, qr0)
        q = qr0
        for c in (dt / 3.0, dt / 2.0, dt):
            q = qr0 + c * self.sedimentation_tendency(rho, d["h"], q, vt1)
        out["qr"] = q
        # the surface precipitation
        vt = self.fall_velocity(rho, out["qr"])
        out["prec"], out["accprec"] = self.precipitation(rho, out["qr"], vt, out["accprec"], dt)
        return out

    def chain(self, st: Fields):
        """fc's physics chain on a stage's input: the tendencies of s, su,
        sv and the mass fractions."""
        su_t, sv_t = self.smagorinsky(st["s"], st["su"], st["sv"])
        tend = dict(su=self.with_inner(torch.zeros_like(st["su"]), su_t),
                    sv=self.with_inner(torch.zeros_like(st["sv"]), sv_t))
        exn, qvs = self.saturation(st)
        qv, qc, qr = st["qv"], st["qc"], st["qr"]
        ev, ec, er = self.kessler_tendencies(st["rho"], qvs, qv, qc, qr)
        dq = self.adjustment(st["t"], qvs, qv, qc)
        ttd = -LHVW / exn * ev - self.sr * (LHVW / exn) * dq
        tend["qv"] = ev + self.sr * dq
        tend["qc"] = ec - self.sr * dq
        tend["qr"] = er
        tend["s"] = self.vertical_tendency(ttd, st["s"])
        tend["su"] = tend["su"] + self.vertical_tendency(ttd, st["su"])
        tend["sv"] = tend["sv"] + self.vertical_tendency(ttd, st["sv"])
        for q in ("qv", "qc", "qr"):
            tend[q] = tend[q] + self.vertical_tendency(ttd, st["s"] * st[q], st["s"])
        vt = self.fall_velocity(st["rho"], qr)
        tend["qr"] = tend["qr"] + self.sedimentation_tendency(st["rho"], st["h"], qr, vt)
        return tend, ttd

    def step_fc(self, st: Fields, hs) -> Fields:
        dt = self.dt
        cur = dict(st)
        for k in range(len(STAGES)):
            tend, cur["ttd"] = self.chain(cur)
            cur.update(self.stage(k, st, cur, hs, tend))
            cur.update(self.diagnostics(cur["s"], hs))
        vt = self.fall_velocity(cur["rho"], cur["qr"])
        cur["prec"], cur["accprec"] = self.precipitation(cur["rho"], cur["qr"], vt, cur["accprec"], dt)
        names = ("s", "su", "sv", "qv", "qc", "qr")
        cur.update(zip(names, self.smoothing([cur[n] for n in names])))
        cur["u"], cur["v"] = self.velocities(cur["s"], cur["su"], cur["sv"])
        return cur
