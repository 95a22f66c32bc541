"""Static-quality checks — the Aqua.jl analogue (``test/test_aqua.jl``):
every exported name resolves, public call signatures are importable, and
the package has no import-time side effects on jax config."""

import importlib
import inspect

import pytest


def test_all_exports_resolve():
    import pdmpflux_tpu as pf

    for name in pf.__all__:
        assert hasattr(pf, name), f"__all__ lists missing name {name}"

    for name in pf.models.__all__:
        assert hasattr(pf.models, name)

    for name in pf.parallel.__all__:
        assert hasattr(pf.parallel, name)


def test_submodules_import_clean():
    for mod in [
        "pdmpflux_tpu.core.types",
        "pdmpflux_tpu.core.bounds",
        "pdmpflux_tpu.core.engine",
        "pdmpflux_tpu.core.capability",
        "pdmpflux_tpu.models",
        "pdmpflux_tpu.ops.flows",
        "pdmpflux_tpu.parallel",
        "pdmpflux_tpu.parallel.sharded",
        "pdmpflux_tpu.streaming",
        "pdmpflux_tpu.diagnostics",
        "pdmpflux_tpu.plotting",
        "pdmpflux_tpu.utils.potentials",
        "pdmpflux_tpu.utils.profiling",
        "pdmpflux_tpu.api",
    ]:
        importlib.import_module(mod)


def test_sampler_constructors_share_core_signature():
    """All manual-gradient constructors accept (dim, grad_U) positionally and
    the shared bound-strategy kwargs (API-parity guard)."""
    import pdmpflux_tpu as pf

    shared = {"grid_size", "tmax", "adaptive"}
    for cls in [pf.ZigZag, pf.BPS, pf.Boomerang, pf.ForwardECMC,
                pf.SpeedUpZigZag]:
        sig = inspect.signature(cls.__init__)
        params = set(sig.parameters)
        missing = shared - params
        assert not missing or "kw" in params, (cls, missing)


def test_no_import_time_jax_config_mutation():
    import jax

    before = jax.config.jax_enable_x64
    importlib.reload(importlib.import_module("pdmpflux_tpu.utils.potentials"))
    assert jax.config.jax_enable_x64 == before
