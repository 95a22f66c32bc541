"""Boomerang sampler (elliptic flow with N(0, I) reference measure).

Counterpart of ``/root/reference/src/Samplers/BoomerangSamplers.jl``.

Documented correctness fix: the reference's event *rate* uses the raw
gradient ``<grad_U(x_t), v_t>`` (BoomerangSamplers.jl:38-46) while its
velocity *jump* bounces on the effective gradient
``grad_U(x) - x`` (:51-63) — and the reference docs
(``docs/src/tutorials/samplers.md:89``) state the rate should use the
effective gradient.  For the Boomerang process with Gaussian reference
measure the correct event rate is ``max(0, <v, grad_U(x_t) - x_t>) +
refresh``; we implement that (rate and jump consistently on the effective
gradient), since the rate enters the thinning acceptance ratio and therefore
the sampled law (unlike envelope slack, this is not self-correcting).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.flows import boomerang_flow
from .base import PDMP, dot, resolve_potential


class Boomerang(PDMP):
    """Defaults as in ``BoomerangSamplers.jl:21-23``."""

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
        **kw,
    ):
        del vectorized_bound  # forced off (:36)
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
        self.rate_vect = None
        self.signed_rate = self._signed_rate
        self.signed_rate_vect = None

    def _grad_eff(self, x):
        return self.grad_U(x) - x

    def flow(self, x, v, t):
        return boomerang_flow(x, v, t)

    def rate(self, x, v, t):
        xt, vt = self.flow(x, v, t)
        return jnp.maximum(0.0, dot(self._grad_eff(xt), vt)) + self.refresh_rate

    def _signed_rate(self, x, v, t):
        # No refresh term: the envelope builder adds refresh_rate once after
        # the max-with-0 — tight, unlike the reference's double-count (see
        # the same note in bps.py; BoomerangSamplers.jl:44-46 +
        # UpperBound.jl:131).  On a pure-Gaussian target (grad_eff == 0)
        # this lifts thinning acceptance from exactly 0.5 to ~1.
        xt, vt = self.flow(x, v, t)
        return dot(self._grad_eff(xt), vt)

    def velocity_jump(self, x, v, key, is_active):
        g = self._grad_eff(x)
        bounce_rate = jnp.maximum(0.0, dot(g, v))
        denom = bounce_rate + self.refresh_rate
        bounce_prob = jnp.where(denom > 0, bounce_rate / jnp.where(denom > 0, denom, 1.0), 0.0)
        k_u, k_n = jax.random.split(key)
        u = jax.random.uniform(k_u, dtype=x.dtype)

        nrm = jnp.linalg.norm(g)
        e = g / jnp.where(nrm > 0, nrm, 1.0)
        v_reflect = v - 2.0 * dot(v, e) * e
        # Full refresh draws an *un-normalized* Gaussian velocity (:65) —
        # correct for the Boomerang's Gaussian velocity marginal.
        fresh = jax.random.normal(k_n, v.shape, v.dtype)
        return jnp.where(u < bounce_prob, v_reflect, fresh)


def BoomerangAD(dim, U, *, refresh_rate=0.0, grid_size=10, tmax=2.0,
                signed_bound=True, adaptive=True, **kw):
    """``BoomerangAD`` (``BoomerangSamplers.jl:79-87``) — reference AD
    defaults: ``refresh_rate=0.0``, ``tmax=2.0``."""
    U_vec, grad_U = resolve_potential(U, dim)
    return Boomerang(
        dim, grad_U, potential=U_vec, refresh_rate=refresh_rate,
        grid_size=grid_size, tmax=tmax, signed_bound=signed_bound,
        adaptive=adaptive, **kw,
    )
