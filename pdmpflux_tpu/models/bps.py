"""Bouncy Particle Sampler.

Counterpart of ``/root/reference/src/Samplers/BouncyParticleSamplers.jl``:
linear flow, scalar rate ``max(0, <grad_U(x_t), v_t>) + refresh_rate``,
bounce-or-refresh velocity kernel (:50-74).  The bound strategy is forced
non-vectorized (:35-37).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.flows import linear_flow
from .base import PDMP, dot, resolve_potential


class BPS(PDMP):
    """Defaults as in ``BouncyParticleSamplers.jl:21-24`` (note
    ``tmax=1.0`` and ``refresh_rate=0.1`` for the manual-gradient
    constructor; ``BPSAD`` below uses the reference's different defaults)."""

    def __init__(
        self,
        dim,
        grad_U,
        *,
        grid_size=10,
        tmax=1.0,
        refresh_rate=0.1,
        vectorized_bound=False,
        signed_bound=True,
        adaptive=True,
        gaussian_velocity=False,
        **kw,
    ):
        del vectorized_bound  # forced off for BPS (:37)
        super().__init__(
            dim,
            grad_U,
            grid_size=grid_size,
            tmax=tmax,
            refresh_rate=refresh_rate,
            vectorized_bound=False,
            signed_bound=signed_bound,
            adaptive=adaptive,
            **kw,
        )
        self.gaussian_velocity = bool(gaussian_velocity)
        self.rate_vect = None
        self.signed_rate = self._signed_rate
        self.signed_rate_vect = None

    def flow(self, x, v, t):
        return linear_flow(x, v, t)

    def rate(self, x, v, t):
        xt, vt = self.flow(x, v, t)
        return jnp.maximum(0.0, dot(self.grad_U(xt), vt)) + self.refresh_rate

    def _signed_rate(self, x, v, t):
        # No refresh term here: the signed-grid envelope builder adds
        # refresh_rate ONCE after the max-with-0 (base.bound_box ->
        # upper_bound_grid), giving the tight envelope max(env(<g,v>),0)+r.
        # The reference double-counts (its signed closure includes refresh,
        # BouncyParticleSamplers.jl:44-47, AND upper_bound_grid adds it
        # again, UpperBound.jl:131) which caps acceptance at l/(l+r) —
        # envelope slack only, law identical (documented deviation).
        xt, vt = self.flow(x, v, t)
        return dot(self.grad_U(xt), vt)

    def velocity_jump(self, x, v, key, is_active):
        g = self.grad_U(x)
        bounce_rate = jnp.maximum(0.0, dot(g, v))
        denom = bounce_rate + self.refresh_rate
        # 0/0 -> prob 0 -> refresh branch, matching Julia's u < NaN == false.
        bounce_prob = jnp.where(denom > 0, bounce_rate / jnp.where(denom > 0, denom, 1.0), 0.0)
        k_u, k_n = jax.random.split(key)
        u = jax.random.uniform(k_u, dtype=x.dtype)

        gg = dot(g, g)
        scale = 2.0 * dot(v, g) / jnp.where(gg > 0, gg, 1.0)
        v_reflect = jnp.where(gg > 0, v - scale * g, v)

        fresh = jax.random.normal(k_n, v.shape, v.dtype)
        if not self.gaussian_velocity:
            nrm = jnp.linalg.norm(fresh)
            fresh = fresh / jnp.where(nrm > 0, nrm, 1.0)

        return jnp.where(u < bounce_prob, v_reflect, fresh)


def BPSAD(dim, U, *, refresh_rate=0.0, grid_size=10, tmax=2.0,
          signed_bound=True, adaptive=True, **kw):
    """``BPSAD`` (``BouncyParticleSamplers.jl:86-94``) — note the reference's
    AD constructor defaults differ from ``BPS``: ``refresh_rate=0.0`` and
    ``tmax=2.0``; ``vectorized_bound`` is not forwarded (forced off)."""
    U_vec, grad_U = resolve_potential(U, dim)
    return BPS(
        dim, grad_U, potential=U_vec, refresh_rate=refresh_rate,
        grid_size=grid_size, tmax=tmax, signed_bound=signed_bound,
        adaptive=adaptive, **kw,
    )
