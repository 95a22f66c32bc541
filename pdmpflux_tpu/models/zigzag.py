"""Zig-Zag sampler (and its AD-from-potential constructor).

JAX counterpart of the reference's ``src/Samplers/ZigZagSamplers.jl``:
linear flow, per-coordinate rates ``max(0, dU_i(x_t) v_i)``, and a single
coordinate flip at events, sampled proportionally to the per-coordinate
rates (ZigZagSamplers.jl:101-107).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.flows import linear_flow
from .base import PDMP, resolve_potential


class ZigZag(PDMP):
    """Zig-Zag sampler — defaults as in ``ZigZagSamplers.jl:58-60``."""

    def _zigzag_family(self):
        return True

    def __init__(
        self,
        dim,
        grad_U,
        *,
        grid_size=10,
        tmax=2.0,
        refresh_rate=0.0,
        vectorized_bound=True,
        signed_bound=True,
        adaptive=True,
        **kw,
    ):
        super().__init__(
            dim,
            grad_U,
            grid_size=grid_size,
            tmax=tmax,
            refresh_rate=refresh_rate,
            vectorized_bound=vectorized_bound,
            signed_bound=signed_bound,
            adaptive=adaptive,
            **kw,
        )
        self.rate_vect = self._rate_vect
        self.signed_rate = None
        self.signed_rate_vect = self._signed_rate_vect

    def flow(self, x, v, t):
        return linear_flow(x, v, t)

    def rate(self, x, v, t):
        xt, vt = self.flow(x, v, t)
        return jnp.sum(jnp.maximum(0.0, self.grad_U(xt) * vt))

    def _rate_vect(self, x, v, t):
        xt, vt = self.flow(x, v, t)
        return jnp.maximum(0.0, self.grad_U(xt) * vt)

    def _signed_rate_vect(self, x, v, t):
        xt, vt = self.flow(x, v, t)
        return self.grad_U(xt) * vt

    def _flip_rates(self, x, v, is_active):
        """Per-coordinate flip intensities at an event.

        The reference evaluates these on the *full* velocity even for sticky
        runs (``SamplingLoopInplace.jl:178`` passes ``state.v``), which can
        flip the latent velocity of a frozen coordinate.  We mask with
        ``is_active`` so only coordinates that can actually generate events
        are flipped — a documented correctness fix (no-op for non-sticky
        samplers, where ``is_active`` is all-True).
        """
        va = jnp.where(is_active, v, jnp.zeros_like(v))
        return jnp.maximum(0.0, self.grad_U(x) * va)

    def velocity_jump(self, x, v, key, is_active):
        lam = self._flip_rates(x, v, is_active)
        logits = jnp.where(lam > 0, jnp.log(jnp.where(lam > 0, lam, 1.0)), -jnp.inf)
        m = jax.random.categorical(key, logits)
        return v.at[m].multiply(-1.0)


def ZigZagAD(dim, U, **kw):
    """``ZigZagAD`` (``ZigZagSamplers.jl:118-126``): build ``grad_U`` by AD.

    JAX's single AD replaces the reference's backend selection; an
    ``ad_backend`` kwarg is accepted for API parity and recorded.
    """
    U_vec, grad_U = resolve_potential(U, dim)
    sampler = ZigZag(dim, grad_U, potential=U_vec, **kw)
    return sampler
