"""Forward Event-Chain Monte Carlo.

Counterpart of ``/root/reference/src/Samplers/ForwardEventChainMonteCarlo.jl``:
linear flow, scalar rate ``max(0, <grad_U, v>)``, and the gradient-frame
velocity jump (:132-176): a radial draw ``rho = -sqrt(1 - u^(2/(dim-1)))``
along the normalized gradient, with the orthogonal component either kept,
refreshed by an orthogonal switch (two Gram-Schmidt directions + planar
rotation, :60-88), or fully refreshed (:105-113).

Constraints preserved from the reference: ``dim >= 2`` (:309-311) and
``mix_p = 0`` when ``dim == 2`` (zero-division guard, :312-314).

Documented deviation: the reference's ``normal`` radial variant (:220-260)
computes ``rho = speed_factor * -sqrt(abs2.(u))`` with ``u = randn(2)``,
which produces a *vector* rho (a Julia bug — the result silently broadcasts).
We implement the evident intent: a scalar half-normal radial component
``rho = speed_factor * (-|randn()|)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.flows import linear_flow
from .base import PDMP, dot, resolve_potential

TOLERANCE = 1e-10
MIN_DIMENSION = 2


def _normalize(u, eps=0.0):
    n = jnp.linalg.norm(u)
    return u / jnp.where(n > eps, n, 1.0), n


class ForwardECMC(PDMP):
    """Defaults as in ``ForwardEventChainMonteCarlo.jl:301-303``, except
    ``grid_size=20`` (the reference uses 10).

    On the 10-d Gaussian benchmark (f32) the scalar signed envelope's
    slack is segment-width-limited, so doubling the grid raises thinning
    acceptance 0.889 -> 0.928; grid 40 reaches 0.956 but pays more
    envelope work than its rejections save.  The speed trade-off behind
    the default has not been re-measured on a GPU (see ROADMAP.md).  The
    initial ``tmax`` is irrelevant to acceptance — the adaptive horizon
    self-tunes within a few hundred events.  The sampled law is identical
    at any grid (envelope tightness only shifts acceptance statistics)."""

    def __init__(
        self,
        dim,
        grad_U,
        *,
        grid_size=20,
        tmax=2.0,
        signed_bound=True,
        adaptive=True,
        ran_p=False,
        mix_p=0.5,
        switch=True,
        positive=True,
        speed_factor=1.0,
        normal=False,
        **kw,
    ):
        if dim < MIN_DIMENSION:
            raise ValueError(
                f"The dimension must be at least {MIN_DIMENSION} to use the "
                f"ForwardEventChain. Got dimension {dim}"
            )
        if dim == 2:
            mix_p = 0.0  # orthogonal refresh in dim < 3 causes zero division
        super().__init__(
            dim,
            grad_U,
            grid_size=grid_size,
            tmax=tmax,
            refresh_rate=0.0,  # forced (:322-323)
            vectorized_bound=False,  # forced (:321)
            signed_bound=signed_bound,
            adaptive=adaptive,
            **kw,
        )
        self.ran_p = bool(ran_p)
        self.mix_p = float(mix_p)
        self.switch = bool(switch)
        self.positive = bool(positive)
        self.speed_factor = float(speed_factor)
        self.normal = bool(normal)
        self.rate_vect = None
        self.signed_rate = self._signed_rate
        self.signed_rate_vect = None

    def flow(self, x, v, t):
        return linear_flow(x, v, t)

    def rate(self, x, v, t):
        xt, vt = self.flow(x, v, t)
        return jnp.maximum(0.0, dot(self.grad_U(xt), vt))

    def _signed_rate(self, x, v, t):
        xt, vt = self.flow(x, v, t)
        return dot(self.grad_U(xt), vt)

    # -- jump helpers -------------------------------------------------------
    def _orthogonal_switch(self, v_o, n, key, dtype):
        """Orthogonal switch (:60-88): rotate v_o within a random 2-plane of
        the orthogonal complement of n."""
        k_g, k_theta = jax.random.split(key)
        g = jax.random.normal(k_g, (2,) + n.shape, dtype)
        g1 = g[0] - dot(g[0], n) * n
        g2 = g[1] - dot(g[1], n) * n
        e1, _ = _normalize(g1)
        e2 = g2 - dot(g2, e1) * e1
        e2, _ = _normalize(e2)
        c1 = dot(v_o, e1)
        c2 = dot(v_o, e2)
        v_r = v_o - c1 * e1 - c2 * e2
        v_new = v_r + e2 * c1 + e1 * c2
        if self.ran_p:
            theta = jax.random.uniform(k_theta, dtype=dtype) * 2.0 * jnp.pi
            ct, st = jnp.cos(theta), jnp.sin(theta)
            v_new = v_r + (ct * e1 + st * e2) * c1 + (st * e1 - ct * e2) * c2
        if self.positive:
            s = jnp.sign(dot(v_o, v_new))
            v_new = v_new * jnp.where(s == 0, 1.0, s)
        return v_new

    def _full_refresh(self, n, key, dtype):
        """Full orthogonal refresh (:105-113)."""
        g = jax.random.normal(key, n.shape, dtype)
        g, _ = _normalize(g)
        return g - dot(g, n) * n

    def velocity_jump(self, x, v, key, is_active):
        dtype = x.dtype
        dim = self.dim
        sf = self.speed_factor
        k_rho, k_mix, k_deg, k_ref = jax.random.split(key, 4)

        # radial component along the (normalized) gradient
        if self.normal:
            rho = sf * (-jnp.abs(jax.random.normal(k_rho, dtype=dtype)))
        else:
            u = jax.random.uniform(k_rho, dtype=dtype)
            rho = sf * (-jnp.sqrt(1.0 - u ** (2.0 / (dim - 1))))

        g = self.grad_U(x)
        n, ng = _normalize(g)
        n = jnp.where(ng > 0, n, jnp.zeros_like(n))

        v_p = dot(v, n) * n
        v_o = v - v_p
        # degenerate orthogonal component regeneration (:159-162)
        deg = jnp.linalg.norm(v_o) < TOLERANCE
        fresh_o = jax.random.normal(k_deg, v.shape, dtype)
        fresh_o = fresh_o - dot(fresh_o, n) * n
        v_o = jnp.where(deg, fresh_o, v_o)

        if self.switch:
            v_o_prop = self._orthogonal_switch(v_o, n, k_ref, dtype)
        else:
            v_o_prop = self._full_refresh(n, k_ref, dtype)

        u2 = jax.random.uniform(k_mix, dtype=dtype)
        refresh = u2 < self.mix_p
        v_o_sel = jnp.where(refresh, v_o_prop, v_o)
        v_o_unit, _ = _normalize(v_o_sel)

        if self.normal:
            # speed depends on the pre-normalization orthogonal magnitude (:251, :257)
            mag2 = jnp.sum(v_o_sel * v_o_sel)
            tangential = jnp.sqrt(jnp.maximum(0.0, sf * sf * mag2 - rho * rho))
        else:
            tangential = jnp.sqrt(jnp.maximum(0.0, sf * sf - rho * rho))
        return v_o_unit * tangential + rho * n


def ForwardECMCAD(dim, U, *, grid_size=20, tmax=2.0, signed_bound=True,
                  adaptive=True, ran_p=False, mix_p=0.5, switch=True,
                  positive=True, speed_factor=1.0, **kw):
    """``ForwardECMCAD`` (``ForwardEventChainMonteCarlo.jl:367-378``)."""
    U_vec, grad_U = resolve_potential(U, dim)
    return ForwardECMC(
        dim, grad_U, potential=U_vec, grid_size=grid_size, tmax=tmax,
        signed_bound=signed_bound, adaptive=adaptive, ran_p=ran_p,
        mix_p=mix_p, switch=switch, positive=positive,
        speed_factor=speed_factor, **kw,
    )
