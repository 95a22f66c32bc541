"""Randomized Hamiltonian Monte Carlo as a PDMP.

Counterpart of
``/root/reference/src/Samplers/RandomizedHamiltonianMonteCarlo.jl``:
velocity-Verlet Hamiltonian flow between events, a *constant* Poisson
refresh clock ``rate = refresh_rate`` (:133), and Horowitz partial momentum
refreshment ``v <- cos(phi) v + sin(phi) xi`` at events (:143-148).

Like the reference's specialized ``init_state`` (:194-224), the bound is the
trivial two-point constant box — no optimization, no grid.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..core.types import BoundBox
from ..ops.flows import make_verlet_flow
from .base import PDMP, resolve_potential


def _auto_horizon(refresh_rate: float, step_size: float,
                  overhead_steps: float = 14.0) -> float:
    """Throughput-optimal thinning horizon for RHMC's constant clock.

    The reference defaults ``tmax = 10.0``
    (``RandomizedHamiltonianMonteCarlo.jl:55``), which is catastrophic for a
    lane-batched Verlet flow: under ``vmap`` every transition integrates for
    the SLOWEST lane's proposal, and with an ``Exp(refresh_rate)`` proposal
    truncated at the horizon the batch maximum approaches the horizon itself
    (~``tmax / h`` steps per transition for every lane, vs a mean event
    needing ``1 / (refresh_rate * h)``).

    A *short* horizon caps each transition's lockstep cost at ``T / h``
    steps while keeping the per-event law identical (the horizon only
    segments the constant Poisson clock; horizon moves integrate the same
    flow they would have integrated inside a longer proposal).  Cost per
    event ``(T / h + c) / (1 - exp(-lam T))`` — ``c`` transition overheads
    in Verlet-step units — is minimized on a coarse grid here.  The
    default ``c ~ 14`` puts the optimum at ``lam * T ~ 1``: each
    transition's bound/RNG/state machinery is taken to cost about fourteen
    Verlet gradient steps (B=512, 10-d Gaussian, refresh 1.0, h=0.05; not
    yet re-measured on a GPU, see ROADMAP.md).  Explicit ``tmax``
    (including the reference's 10.0) is honored unchanged.
    """
    lam, h = float(refresh_rate), float(step_size)
    best_T, best_cost = 1.0 / lam, float("inf")
    for i in range(1, 400):
        T = i * 0.05 / lam
        cost = (T / h + overhead_steps) / (1.0 - math.exp(-lam * T))
        if cost < best_cost:
            best_T, best_cost = T, cost
    return best_T


class RHMC(PDMP):
    """Defaults as in ``RandomizedHamiltonianMonteCarlo.jl:48-57``, except
    ``tmax=None`` resolves to a lane-batching-optimal horizon (see
    :func:`_auto_horizon`; the reference's fixed 10.0 is honored when passed
    explicitly — the sampled law is identical either way)."""

    def __init__(
        self,
        dim,
        grad_U,
        *,
        mean_duration=None,
        refresh_rate=1.0,
        phi=math.pi / 2,
        step_size=0.05,
        tmax=None,
        adaptive=False,
        **kw,
    ):
        if mean_duration is not None:
            md = float(mean_duration)
            if not math.isfinite(md) or md <= 0:
                raise ValueError(
                    f"mean_duration must be finite and positive. Current value: {mean_duration}"
                )
            refresh_rate = 1.0 / md
        refresh_rate = float(refresh_rate)
        if not math.isfinite(refresh_rate) or refresh_rate <= 0:
            raise ValueError(
                f"refresh_rate must be finite and positive. Current value: {refresh_rate}"
            )
        phi = float(phi)
        if not (0.0 < phi <= math.pi / 2):
            raise ValueError(f"phi must satisfy 0 < phi <= pi/2. Current value: {phi}")
        step_size = float(step_size)
        if not math.isfinite(step_size) or step_size <= 0:
            raise ValueError(
                f"step_size must be finite and positive. Current value: {step_size}"
            )
        if tmax is None:
            tmax = _auto_horizon(refresh_rate, step_size)
        tmax = float(tmax)
        if not math.isfinite(tmax) or tmax < 0:
            raise ValueError(f"tmax must be finite and non-negative. Current value: {tmax}")

        super().__init__(
            dim,
            grad_U,
            grid_size=0,          # constant refresh clock only (:91-94)
            tmax=tmax,
            refresh_rate=refresh_rate,
            vectorized_bound=False,
            signed_bound=False,
            adaptive=adaptive,
            **kw,
        )
        self.phi = phi
        self.step_size = step_size
        self._flow = make_verlet_flow(self.grad_U, step_size)
        self.rate_vect = None
        self.signed_rate = None
        self.signed_rate_vect = None

    def flow(self, x, v, t):
        return self._flow(x, v, t)

    def rate(self, x, v, t):
        return jnp.asarray(self.refresh_rate, x.dtype)

    def bound_box(self, x, v, horizon):
        """Trivial constant box — specialized ``init_state`` (:208-218)."""
        lam = jnp.asarray(self.refresh_rate, x.dtype)
        grid = jnp.stack([jnp.zeros_like(horizon), horizon])
        box = jnp.reshape(lam, (1,))
        cum = jnp.stack([jnp.zeros_like(horizon), lam * horizon])
        return BoundBox(grid=grid, box_max=box, cum_sum=cum, step_size=horizon)

    def velocity_jump(self, x, v, key, is_active):
        xi = jax.random.normal(key, v.shape, v.dtype)
        return math.cos(self.phi) * v + math.sin(self.phi) * xi


def RHMCAD(dim, U, **kw):
    """``RHMCAD`` (``RandomizedHamiltonianMonteCarlo.jl:182-186``)."""
    U_vec, grad_U = resolve_potential(U, dim)
    return RHMC(dim, grad_U, potential=U_vec, **kw)
