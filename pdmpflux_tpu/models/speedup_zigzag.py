"""Speed-Up Zig-Zag: Zig-Zag under the speed change ``s(x) = sqrt(1+|x|^2)``.

Counterpart of ``/root/reference/src/Samplers/SpeedUpZigZagSamplers.jl``:
closed-form nonlinear flow (:71-79) and Zig-Zag-structured rates/jump on the
effective gradient ``grad_U_eff(x) = s(x) grad_U(x) - x / s(x)`` (:81-110).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.flows import make_suzz_flow
from .zigzag import ZigZag
from .base import resolve_potential


class SpeedUpZigZag(ZigZag):
    """Defaults as in ``SpeedUpZigZagSamplers.jl:58-69`` (same flag logic as
    ZigZag)."""

    def __init__(self, dim, grad_U, **kw):
        super().__init__(dim, grad_U, **kw)
        self._suzz_flow = make_suzz_flow(dim)

    def _grad_eff(self, x):
        # jnp.sum(x * x), not jnp.dot: full f32 precision on a GPU (see
        # ops/flows.py make_suzz_flow note)
        s = jnp.sqrt(1.0 + jnp.sum(x * x))
        return s * self.grad_U(x) - x / s

    def flow(self, x, v, t):
        return self._suzz_flow(x, v, t)

    def rate(self, x, v, t):
        xt, vt = self.flow(x, v, t)
        return jnp.sum(jnp.maximum(0.0, self._grad_eff(xt) * vt))

    def _rate_vect(self, x, v, t):
        xt, vt = self.flow(x, v, t)
        return jnp.maximum(0.0, self._grad_eff(xt) * vt)

    def _signed_rate_vect(self, x, v, t):
        xt, vt = self.flow(x, v, t)
        return self._grad_eff(xt) * vt

    def _flip_rates(self, x, v, is_active):
        va = jnp.where(is_active, v, jnp.zeros_like(v))
        return jnp.maximum(0.0, self._grad_eff(x) * va)


def SpeedUpZigZagAD(dim, U, **kw):
    """``SpeedUpZigZagAD`` (``SpeedUpZigZagSamplers.jl:121-129``)."""
    U_vec, grad_U = resolve_potential(U, dim)
    return SpeedUpZigZag(dim, grad_U, potential=U_vec, **kw)
