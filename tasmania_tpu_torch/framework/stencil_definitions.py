"""The generic registered stencils (counterpart of
``tasmania_tpu/framework/stencil_definitions.py``): state algebra, boundary
relaxation, the sequential-tendency stage combinations and the Thomas
tridiagonal solver, and the subroutines ``absolute``, ``positive``,
``negative`` and ``laplacian_2d``.

Every definition is functional (it returns a new array) and registered under
``"torch"`` (tensors on any device) and ``"numpy"`` (host arrays); one body
serves both through ``utils/array.get_namespace``, except the Thomas solve,
which has a host version and a tensor version.

The JAX package sweeps the Thomas solve's levels with two ``lax.scan``s,
each step one elementwise update of a whole (x, y) plane; it has no Pallas
kernel, so the port is plain PyTorch in the same shape: a forward sweep and
a back substitution over the levels, each level one set of operations on
whole planes.  The coefficients are copied to a level-major layout once, so
that a level's plane is contiguous rather than strided by nz.
"""

from __future__ import annotations

import numpy as np
import torch

from tasmania_tpu_torch.framework.stencil import stencil_definition, subroutine_definition
from tasmania_tpu_torch.utils.array import get_namespace

_ALL = ("torch", "numpy")


@stencil_definition("copy", backend=_ALL)
def copy(src):
    return np.array(src, copy=True) if get_namespace(src) is np else src.clone()


@stencil_definition("copychange", backend=_ALL)
def copychange(src):
    return -src


@stencil_definition("abs", backend=_ALL)
def abs_(phi):
    return get_namespace(phi).abs(phi)


@stencil_definition("add", backend=_ALL)
def add(a, b):
    return a + b


@stencil_definition("sub", backend=_ALL)
def sub(a, b):
    return a - b


@stencil_definition("mul", backend=_ALL)
def mul(a, b):
    return a * b


@stencil_definition("scale", backend=_ALL)
def scale(phi, *, f):
    return f * phi


@stencil_definition("addsub", backend=_ALL)
def addsub(a, b, c):
    return a + b - c


@stencil_definition("fma", backend=_ALL)
def fma(a, b, *, f):
    return a + f * b


@stencil_definition("clip", backend=_ALL)
def clip(phi):
    xp = get_namespace(phi)
    return xp.where(phi > 0, phi, xp.zeros_like(phi))


@stencil_definition("relax", backend=_ALL)
def relax(gamma, phi, phi_ref):
    """Relaxation towards a reference state: gamma == 0 keeps phi,
    gamma == 1 gives phi_ref, a value between blends them."""
    return phi - gamma * (phi - phi_ref)


@stencil_definition("sts_rk2_0", backend=_ALL)
def sts_rk2_0(field, field_prv, tnd, *, dt):
    return 0.5 * (field + field_prv + dt * tnd)


@stencil_definition("sts_rk3ws_0", backend=_ALL)
def sts_rk3ws_0(field, field_prv, tnd, *, dt):
    return (2.0 * field + field_prv + dt * tnd) / 3.0


@stencil_definition("thomas", backend="numpy")
def thomas_numpy(a, b, c, d):
    """Solve tridiagonal systems along the LAST axis, vectorised over the
    leading axes: a forward sweep and a back substitution."""
    n = b.shape[-1]
    cp = np.zeros_like(b)
    dp = np.zeros_like(b)
    cp[..., 0] = c[..., 0] / b[..., 0]
    dp[..., 0] = d[..., 0] / b[..., 0]
    for k in range(1, n):
        denom = b[..., k] - a[..., k] * cp[..., k - 1]
        cp[..., k] = c[..., k] / denom
        dp[..., k] = (d[..., k] - a[..., k] * dp[..., k - 1]) / denom
    x = np.zeros_like(b)
    x[..., n - 1] = dp[..., n - 1]
    for k in range(n - 2, -1, -1):
        x[..., k] = dp[..., k] - cp[..., k] * x[..., k + 1]
    return x


def thomas_level_major(a, b, c, d):
    """Solve the tridiagonal systems whose level is the FIRST axis.

    ``a`` (the sub-diagonal, ``a[0]`` unused), ``b`` (the diagonal) and ``c``
    (the super-diagonal, ``c[-1]`` unused) have shape (n, ...); ``d`` has
    shape (n, ...) or (n, m, ...), m right-hand sides that share the matrix,
    which then is swept once.  Each level updates in the JAX order:
    ``denom = b - a·cp⁻``, ``cp = c / denom``, ``dp = (d - a·dp⁻) / denom``,
    then ``x = dp - cp·x⁺``, with zeros before the first level and after
    the last."""
    n = b.shape[0]
    if d.dim() > b.dim():  # the right-hand sides' axis after the level's
        a, b, c = a.unsqueeze(1), b.unsqueeze(1), c.unsqueeze(1)
    cp = torch.empty(b.shape, dtype=d.dtype, device=d.device)
    dp = torch.empty_like(d)
    cp_prev = torch.zeros_like(cp[0])
    dp_prev = torch.zeros_like(dp[0])
    for k in range(n):
        denom = b[k] - a[k] * cp_prev
        cp_prev = torch.div(c[k], denom, out=cp[k])
        dp_prev = torch.div(d[k] - a[k] * dp_prev, denom, out=dp[k])
    x = torch.empty_like(d)
    x_next = torch.zeros_like(dp[0])
    for k in range(n - 1, -1, -1):
        x_next = torch.sub(dp[k], cp[k] * x_next, out=x[k])
    return x


@stencil_definition("thomas", backend="torch")
def thomas(a, b, c, d):
    """Solve tridiagonal systems along the LAST axis, batched over the
    leading ones (``thomas_jax``'s contract): ``a`` the sub-diagonal
    (``a[..., 0]`` unused), ``b`` the diagonal, ``c`` the super-diagonal
    (``c[..., -1]`` unused), ``d`` the right-hand side.  ``d`` may carry one
    more leading axis than the coefficients: that many right-hand sides
    sharing the matrix, which is then swept once.  A tensor already
    level-major in memory (a ``movedim`` view) is not copied on the way in."""
    lm = [t.movedim(-1, 0).contiguous() for t in (a, b, c, d)]
    return thomas_level_major(*lm).movedim(0, -1).contiguous()


@subroutine_definition("absolute", backend=_ALL)
def absolute(phi):
    return get_namespace(phi).abs(phi)


@subroutine_definition("positive", backend=_ALL)
def positive(phi):
    xp = get_namespace(phi)
    return xp.where(phi > 0, phi, xp.zeros_like(phi))


@subroutine_definition("negative", backend=_ALL)
def negative(phi):
    xp = get_namespace(phi)
    return xp.where(phi < 0, -phi, xp.zeros_like(phi))


@subroutine_definition("laplacian_2d", backend=_ALL)
def laplacian_2d(phi, *, dx, dy):
    """The five-point Laplacian of ``phi`` (nx, ny, nz) on the interior, in
    an array of phi's shape whose one-cell horizontal ring is zero."""
    lap = get_namespace(phi).zeros_like(phi)
    lap[1:-1, 1:-1] = (
        (phi[:-2, 1:-1] - 2.0 * phi[1:-1, 1:-1] + phi[2:, 1:-1]) / (dx * dx)
        + (phi[1:-1, :-2] - 2.0 * phi[1:-1, 1:-1] + phi[1:-1, 2:]) / (dy * dy)
    )
    return lap
