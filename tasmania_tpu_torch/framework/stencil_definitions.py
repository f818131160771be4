"""The Thomas tridiagonal solver (counterpart of ``thomas_jax`` in
``tasmania_tpu/framework/stencil_definitions.py``), the column solve of the
implicit vertical advection.

The JAX package sweeps the levels with two ``lax.scan``s, each step one
elementwise update of a whole (x, y) plane; it has no Pallas kernel, so the
port is plain PyTorch in the same shape: a forward sweep and a back
substitution over the levels, each level one set of operations on whole
planes.  The coefficients are copied to a level-major layout once, so that a
level's plane is contiguous rather than strided by nz.
"""

from __future__ import annotations

import torch


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


def thomas(a, b, c, d):
    """Solve tridiagonal systems along the LAST axis, batched over the
    leading ones (``thomas_jax``'s contract): ``a`` the sub-diagonal
    (``a[..., 0]`` unused), ``b`` the diagonal, ``c`` the super-diagonal
    (``c[..., -1]`` unused), ``d`` the right-hand side."""
    lm = [t.movedim(-1, 0).contiguous() for t in (a, b, c, d)]
    return thomas_level_major(*lm).movedim(0, -1).contiguous()
