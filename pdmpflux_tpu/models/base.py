"""Sampler base class: static configuration + pure dynamics functions.

The reference represents a sampler as a mutable struct of closures
(``/root/reference/src/Samplers/AbstractPDMP.jl``).  Here a sampler is a
plain Python object holding *static* configuration and *pure* functions —
it is never traced itself; the engine builds jit-compiled programs from it
and caches them per (sampler, shape) signature.

A sampler defines five pure maps (cf. SURVEY.md §2 L3):

* ``flow(x, v, t) -> (x_t, v_t)``        deterministic dynamics
* ``rate(x, v, t) -> scalar``            unsigned total event rate λ(t) ≥ 0
* ``rate_vect(x, v, t) -> (d,)``         per-dimension unsigned rate (optional)
* ``signed_rate`` / ``signed_rate_vect`` signed variants for tighter bounds
* ``velocity_jump(x, v, key, is_active) -> v'``  Markov kernel at events

plus the bound-strategy flags ``grid_size / tmax / refresh_rate /
vectorized_bound / signed_bound / adaptive`` with exactly the reference's
resolution logic (``AbstractPDMP.jl:104-136``):

* ``grid_size == 0``    → constant bound on the *unsigned* rate (Brent in the
  reference; fixed-iteration golden-section here);
* unsigned/signed and scalar/vectorized grid bounds otherwise, with the
  refresh rate added only on the scalar-grid path.

The thinning acceptance ratio always uses the unsigned ``rate``
(``SamplingLoopInplace.jl:116``), which is what makes envelope slack affect
efficiency only, never the sampled law.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..core import bounds
from ..core.types import MODE_FRESH, ERROR_RING_SIZE, PDMPState


def dot(a, b):
    """Inner product at full float32 precision: a GPU may otherwise run a
    vmapped f32 ``jnp.dot`` on TF32 tensor cores (~3 decimal digits), which
    would reach the thinning ratio and the velocity jumps."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


def _as_key(seed_or_key):
    if seed_or_key is None:
        return jax.random.key(0)
    if isinstance(seed_or_key, int):
        return jax.random.key(seed_or_key)
    return seed_or_key


def resolve_potential(U: Callable, dim: int):
    """Build ``grad_U`` from a user potential, mirroring the probing logic of
    ``set_AD_backend`` (``/root/reference/src/ADBackend.jl:30-141``):

    * if ``U`` maps ``(dim,) -> (dim,)`` it is treated as an already-supplied
      gradient (ADBackend.jl:55-70);
    * for ``dim == 1``, a scalar-argument convention ``U(x::Real)`` is
      detected and wrapped (ADBackend.jl:38-53);
    * otherwise ``grad_U = jax.grad(U)`` — JAX's single AD replaces the
      reference's Zygote/ForwardDiff/ReverseDiff/Enzyme backend zoo.

    Returns ``(U_vec, grad_U)`` where ``U_vec`` takes a ``(dim,)`` array (or
    ``None`` when the user supplied a gradient, not a potential).
    """
    probe = jnp.zeros((dim,))
    try:
        out = jax.eval_shape(U, probe)
        vector_input_ok = True
    except Exception:
        out = None
        vector_input_ok = False

    if vector_input_ok and out.shape == (dim,) and dim > 1:
        # User handed us a gradient already.
        return None, U
    if vector_input_ok and out.shape in ((), (1,)):
        if out.shape == (1,):
            U_vec = lambda x: U(x)[0]
        else:
            U_vec = U
        return U_vec, jax.grad(U_vec)
    if dim == 1:
        # Scalar-argument convention: U(x::Real).
        scalar_out = jax.eval_shape(U, probe[0])
        if scalar_out.shape == ():
            U_vec = lambda x: U(x[0])
            return U_vec, jax.grad(U_vec)
        if scalar_out.shape == (1,):
            # scalar in, length-1 vector out => user-supplied 1-d gradient
            return None, lambda x: jnp.reshape(U(x[0]), (1,))
    raise ValueError(
        f"Could not interpret potential: U(zeros({dim})) has shape "
        f"{getattr(out, 'shape', None)}; expected a scalar (potential) or "
        f"(dim,) vector (gradient)."
    )


class PDMP:
    """Base class of all PDMP samplers (cf. ``AbstractPDMP``)."""

    sticky: bool = False

    def __init__(
        self,
        dim: int,
        grad_U: Callable,
        *,
        grid_size: int = 10,
        tmax: float = 2.0,
        refresh_rate: float = 0.0,
        vectorized_bound: bool = True,
        signed_bound: bool = True,
        adaptive: bool = True,
        tderiv: str = "jvp",
        potential: Optional[Callable] = None,
        ad_backend: str = "jax",
        AD_backend: Optional[str] = None,
    ):
        # Reference-API compatibility: PDMPFlux spells the kwarg
        # ``AD_backend`` and uses it to pick among Julia AD packages
        # (ADBackend.jl); in JAX there is one AD, so the value is recorded
        # and, for "FiniteDiff", mapped onto the finite-difference
        # time-derivative mode of the envelope.
        if AD_backend is not None:
            ad_backend = AD_backend
            if AD_backend in ("FiniteDiff", "Undefined", ""):
                tderiv = "finite_diff"
        if dim <= 0:
            raise ValueError(f"dimension dim must be positive. Current value: {dim}")
        if grid_size < 0:
            raise ValueError(f"grid_size must be non-negative. Current value: {grid_size}")
        tmax = float(tmax)
        if tmax == 0.0:  # adaptive-horizon trigger, ZigZagSamplers.jl:73
            tmax, adaptive = 1.0, True

        self.dim = dim
        self.grad_U = grad_U
        self.potential = potential
        self.grid_size = int(grid_size)
        self.tmax = tmax
        self.refresh_rate = float(refresh_rate)
        self.vectorized_bound = bool(vectorized_bound)
        self.signed_bound = bool(signed_bound)
        self.adaptive = bool(adaptive)
        self.tderiv = tderiv
        self.ad_backend = ad_backend
        self.kappa = None  # sticky samplers override
        self.state: Optional[PDMPState] = None  # last state, like sampler.state
        self._jit_cache: dict = {}

        if self.signed_bound and not self.vectorized_bound and self._zigzag_family():
            warnings.warn(
                "Signed bound is not compatible with non-vectorized bound for "
                "ZigZag, switching to unsigned bound"
            )
            self.signed_bound = False

    # -- family flags ------------------------------------------------------
    def _zigzag_family(self) -> bool:
        return False

    # -- dynamics interface (subclasses implement) -------------------------
    def flow(self, x, v, t):
        raise NotImplementedError

    def rate(self, x, v, t):
        raise NotImplementedError

    rate_vect: Optional[Callable] = None
    signed_rate: Optional[Callable] = None
    signed_rate_vect: Optional[Callable] = None

    def velocity_jump(self, x, v, key, is_active):
        raise NotImplementedError

    # -- bound strategy resolution (AbstractPDMP.jl:104-136) ---------------
    def bound_box(self, x, v, horizon):
        """The ``upper_bound_func`` closure: envelope of the rate from (x, v)."""
        if self.grid_size == 0:
            # Constant bound always uses the unsigned rate (AbstractPDMP.jl:123).
            fn = lambda t: self.rate(x, v, t)
            return bounds.upper_bound_constant(fn, horizon)

        if self.signed_bound:
            sel_rate, sel_vect = self.signed_rate, self.signed_rate_vect
            refresh = self.refresh_rate
        else:
            sel_rate, sel_vect = self.rate, self.rate_vect
            refresh = 0.0

        if not self.vectorized_bound:
            fn = lambda t: sel_rate(x, v, t)
            return bounds.upper_bound_grid(
                fn, horizon, self.grid_size, refresh, tderiv=self.tderiv
            )
        fn = lambda t: sel_vect(x, v, t)
        return bounds.upper_bound_grid_vect(
            fn, horizon, self.grid_size, tderiv=self.tderiv
        )

    # -- state construction (AbstractPDMP.jl:93-153) -----------------------
    def init_state(self, xinit, vinit, seed=None, dtype=None) -> PDMPState:
        xinit = jnp.asarray(xinit, dtype)
        vinit = jnp.asarray(vinit, dtype)
        if xinit.shape != (self.dim,) or vinit.shape != (self.dim,):
            raise ValueError(
                f"xinit and vinit must have the same dimension as pdmp.dim "
                f"({self.dim}). Current dimensions: xinit ({xinit.shape}), "
                f"vinit ({vinit.shape})"
            )
        dt = xinit.dtype
        key = _as_key(seed)
        key, k_exp, k_tt = jax.random.split(key, 3)
        f = lambda val: jnp.asarray(val, dt)
        if self.sticky:
            kappa = jnp.asarray(self.kappa, dt)
            # all coordinates start active => no thaw clock yet
            tt = f(jnp.inf)
        else:
            tt = f(jnp.inf)
        return PDMPState(
            x=xinit,
            v=vinit,
            t=f(0.0),
            t_comp=f(0.0),
            ts=f(0.0),
            horizon=f(self.tmax),
            bound_h=f(self.tmax),
            exp_rv=jax.random.exponential(k_exp, dtype=dt),
            tt=tt,
            mode=jnp.asarray(MODE_FRESH, jnp.int32),
            ar=f(0.0),
            is_active=jnp.ones((self.dim,), bool),
            rejected=jnp.zeros((), jnp.int32),
            errored_bound=jnp.zeros((), jnp.int32),
            hitting_horizon=jnp.zeros((), jnp.int32),
            error_value_ar=jnp.zeros((ERROR_RING_SIZE,), dt),
            key=key,
        )

    def init_state_batch(self, xinit, vinit, seed=None, dtype=None) -> PDMPState:
        """Initialize a batch of chains; ``xinit``/``vinit`` are ``(B, d)``.

        Each chain gets an independent key folded from the seed — the
        counter-based replacement of the reference's single shared
        ``MersenneTwister`` (``AbstractPDMP.jl:100``).
        """
        xinit = jnp.asarray(xinit, dtype)
        vinit = jnp.asarray(vinit, dtype)
        B = xinit.shape[0]
        keys = jax.random.split(_as_key(seed), B)
        return jax.vmap(
            lambda x, v, k: self.init_state(x, v, k, dtype=dtype)
        )(xinit, vinit, keys)

    # -- jit-program cache -------------------------------------------------
    def _cached(self, cache_key, factory):
        fn = self._jit_cache.get(cache_key)
        if fn is None:
            fn = factory()
            self._jit_cache[cache_key] = fn
        return fn
