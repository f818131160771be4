"""Advection terms of the inviscid Burgers equations, orders 1-6
(counterpart of ``tasmania_tpu/burgers/dynamics/advection.py``): the
registered schemes ``FirstOrder`` ... ``SixthOrder`` of the factory base
``BurgersAdvection``.

Odd orders are upwind-biased (a centred term plus a dissipation weighted by
|u|), even orders centred.  ``extent`` is the halo each needs (1, 1, 2, 2,
3, 3): a call takes u and v on a window with ``extent`` more layers on each
side than its output and returns the four terms (u_x, u_y, v_x, v_y of
u·∇u and u·∇v) on the inner window.
"""

from __future__ import annotations

from tasmania_tpu_torch.framework.registry import factor_register, factorize
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND


def _first_order(dx, dy, u, v):
    uc, vc = u[1:-1, 1:-1], v[1:-1, 1:-1]
    abs_u, abs_v = abs(uc), abs(vc)
    adv_u_x = uc / (2.0 * dx) * (u[2:, 1:-1] - u[:-2, 1:-1]) - abs_u / (2.0 * dx) * (
        u[2:, 1:-1] - 2.0 * uc + u[:-2, 1:-1]
    )
    adv_u_y = vc / (2.0 * dy) * (u[1:-1, 2:] - u[1:-1, :-2]) - abs_v / (2.0 * dy) * (
        u[1:-1, 2:] - 2.0 * uc + u[1:-1, :-2]
    )
    adv_v_x = uc / (2.0 * dx) * (v[2:, 1:-1] - v[:-2, 1:-1]) - abs_u / (2.0 * dx) * (
        v[2:, 1:-1] - 2.0 * vc + v[:-2, 1:-1]
    )
    adv_v_y = vc / (2.0 * dy) * (v[1:-1, 2:] - v[1:-1, :-2]) - abs_v / (2.0 * dy) * (
        v[1:-1, 2:] - 2.0 * vc + v[1:-1, :-2]
    )
    return adv_u_x, adv_u_y, adv_v_x, adv_v_y


def _second_order(dx, dy, u, v):
    uc, vc = u[1:-1, 1:-1], v[1:-1, 1:-1]
    adv_u_x = uc / (2.0 * dx) * (u[2:, 1:-1] - u[:-2, 1:-1])
    adv_u_y = vc / (2.0 * dy) * (u[1:-1, 2:] - u[1:-1, :-2])
    adv_v_x = uc / (2.0 * dx) * (v[2:, 1:-1] - v[:-2, 1:-1])
    adv_v_y = vc / (2.0 * dy) * (v[1:-1, 2:] - v[1:-1, :-2])
    return adv_u_x, adv_u_y, adv_v_x, adv_v_y


def _fourth_centred_x(f):
    return 8.0 * (f[3:-1, 2:-2] - f[1:-3, 2:-2]) - (f[4:, 2:-2] - f[:-4, 2:-2])


def _fourth_centred_y(f):
    return 8.0 * (f[2:-2, 3:-1] - f[2:-2, 1:-3]) - (f[2:-2, 4:] - f[2:-2, :-4])


def _third_dissip_x(f, fc):
    return f[4:, 2:-2] + f[:-4, 2:-2] - 4.0 * (f[3:-1, 2:-2] + f[1:-3, 2:-2]) + 6.0 * fc


def _third_dissip_y(f, fc):
    return f[2:-2, 4:] + f[2:-2, :-4] - 4.0 * (f[2:-2, 3:-1] + f[2:-2, 1:-3]) + 6.0 * fc


def _third_order(dx, dy, u, v):
    uc, vc = u[2:-2, 2:-2], v[2:-2, 2:-2]
    abs_u, abs_v = abs(uc), abs(vc)
    adv_u_x = uc / (12.0 * dx) * _fourth_centred_x(u) + abs_u / (12.0 * dx) * _third_dissip_x(u, uc)
    adv_u_y = vc / (12.0 * dy) * _fourth_centred_y(u) + abs_v / (12.0 * dy) * _third_dissip_y(u, uc)
    adv_v_x = uc / (12.0 * dx) * _fourth_centred_x(v) + abs_u / (12.0 * dx) * _third_dissip_x(v, vc)
    adv_v_y = vc / (12.0 * dy) * _fourth_centred_y(v) + abs_v / (12.0 * dy) * _third_dissip_y(v, vc)
    return adv_u_x, adv_u_y, adv_v_x, adv_v_y


def _fourth_order(dx, dy, u, v):
    uc, vc = u[2:-2, 2:-2], v[2:-2, 2:-2]
    adv_u_x = uc / (12.0 * dx) * _fourth_centred_x(u)
    adv_u_y = vc / (12.0 * dy) * _fourth_centred_y(u)
    adv_v_x = uc / (12.0 * dx) * _fourth_centred_x(v)
    adv_v_y = vc / (12.0 * dy) * _fourth_centred_y(v)
    return adv_u_x, adv_u_y, adv_v_x, adv_v_y


def _shifts(f, axis):
    """``f`` over the window inset by 3, shifted by -3..3 along ``axis``."""
    def sh(off):
        if axis == 0:
            return f[3 + off : f.shape[0] - 3 + off, 3:-3]
        return f[3:-3, 3 + off : f.shape[1] - 3 + off]
    return {off: sh(off) for off in (-3, -2, -1, 1, 2, 3)}


def _sixth_centred(dd, s):
    return (45.0 * (s[1] - s[-1]) - 9.0 * (s[2] - s[-2]) + (s[3] - s[-3])) / (60.0 * dd)


def _fifth_dissip(dd, a, s):
    return ((s[3] + s[-3]) - 6.0 * (s[2] + s[-2]) + 15.0 * (s[1] + s[-1]) - 20.0 * a) / (60.0 * dd)


def _fifth_or_sixth(dx, dy, u, v, upwind: bool):
    uc, vc = u[3:-3, 3:-3], v[3:-3, 3:-3]
    terms = []
    for f, fc in ((u, uc), (v, vc)):
        for axis, (dd, w) in enumerate(((dx, uc), (dy, vc))):
            s = _shifts(f, axis)
            term = w * _sixth_centred(dd, s)
            if upwind:
                term = term - abs(w) * _fifth_dissip(dd, fc, s)
            terms.append(term)
    return tuple(terms)


class BurgersAdvection:
    """Factory base: ``BurgersAdvection.factory("third_order")``; ``extent``
    is a scheme's halo."""

    registry = {}
    extent: int = 1

    @staticmethod
    def factory(flux_scheme: str, backend: str = DEFAULT_BACKEND) -> "BurgersAdvection":
        return factorize(flux_scheme, BurgersAdvection, ())

    def __call__(self, dx: float, dy: float, u, v):
        raise NotImplementedError


@factor_register("first_order")
class FirstOrder(BurgersAdvection):
    extent = 1

    def __call__(self, dx, dy, u, v):
        return _first_order(dx, dy, u, v)


@factor_register("second_order")
class SecondOrder(BurgersAdvection):
    extent = 1

    def __call__(self, dx, dy, u, v):
        return _second_order(dx, dy, u, v)


@factor_register("third_order")
class ThirdOrder(BurgersAdvection):
    extent = 2

    def __call__(self, dx, dy, u, v):
        return _third_order(dx, dy, u, v)


@factor_register("fourth_order")
class FourthOrder(BurgersAdvection):
    extent = 2

    def __call__(self, dx, dy, u, v):
        return _fourth_order(dx, dy, u, v)


@factor_register("fifth_order")
class FifthOrder(BurgersAdvection):
    extent = 3

    def __call__(self, dx, dy, u, v):
        return _fifth_or_sixth(dx, dy, u, v, upwind=True)


@factor_register("sixth_order")
class SixthOrder(BurgersAdvection):
    extent = 3

    def __call__(self, dx, dy, u, v):
        return _fifth_or_sixth(dx, dy, u, v, upwind=False)
