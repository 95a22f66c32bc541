"""Smoke run of the sampler's main path on one NVIDIA GPU.

Drives the public entry points (``pf.sample_skeleton``,
``pf.sample_from_skeleton``, ``pf.sample_streaming_stats``) at full size,
checks every result against analytic truth, compares the stream recorder
with the plain scatter recorder (``backend="xla"``) on the card, and prints
one line per phase with the card's name and power limit beside every rate.
The last line of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Usage::

    python chip_smoke.py          # the one-GPU phases
    python chip_smoke.py --four   # only the chain-sharded path, four GPUs

It exits nonzero, printing no result, when the default device is not a GPU
or any phase fails.  The phase functions take their sizes as arguments so
that the tests can run them at tiny sizes on CPU.

Tolerances (all runs are float32):

* moments: within 5 Monte-Carlo standard errors of the analytic value.
  Chains are independent, so the spread of per-chain estimates over ``B``
  chains gives the standard error, autocorrelation included; at 5 SE a
  correct sampler fails with probability below 1e-5 over all checks.
* recorder agreement: the first 64 events of every chain to rtol 1e-5.  The
  two recorders run the same transition in differently fused programs, so
  values may differ in the last bits; after enough events one such
  difference can flip a thinning decision and the paths diverge.
* compaction: log-shift and gather formulations agree bit for bit — both
  only move data.
* sticky ZigZag: spike mass within 0.08 and variance within 0.12 of
  theory, the tolerances of
  ``tests/test_sticky.py::test_spike_mass_matches_theory`` (its z-scores
  are printed, not gated: ~160 events per coordinate leave the
  per-coordinate spike/slab switching short of the mixing the 5-SE rule
  assumes).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

N_SE = 5.0         # moment tolerance in Monte-Carlo standard errors
AGREE_EVENTS = 64  # leading events per chain compared across recorders
AGREE_RTOL = 1e-5
SPIKE_TOL = 0.08
SLAB_VAR_TOL = 0.12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_info() -> str:
    """``name, power.limit`` of every card, from nvidia-smi in a child
    process that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if out.returncode != 0 or not lines:
        return f"nvidia-smi unavailable (exit {out.returncode})"
    return "; ".join(lines)


def _report(phase: str, card: str, **fields):
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {parts} card=[{card}]", flush=True)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def moment_z(samples, mean, var):
    """Largest |estimate - truth| / SE of the pooled mean and of the pooled
    second central moment, from ``(B, n, d)`` post-burn-in samples."""
    B = samples.shape[0]
    m_b = samples.mean(axis=1)
    q_b = ((samples - mean) ** 2).mean(axis=1)
    se_m = m_b.std(axis=0, ddof=1) / math.sqrt(B)
    se_q = q_b.std(axis=0, ddof=1) / math.sqrt(B)
    z_m = np.abs(m_b.mean(axis=0) - mean) / np.maximum(se_m, 1e-12)
    z_q = np.abs(q_b.mean(axis=0) - var) / np.maximum(se_q, 1e-12)
    return float(z_m.max()), float(z_q.max())


def _samples(pf, sampler, skel, n_per_chain):
    """Equal-time samples per chain with the first quarter dropped as
    burn-in (every chain starts from the same deterministic point)."""
    smp = np.asarray(pf.parallel.sample_from_skeleton_batch(
        sampler, n_per_chain, skel))
    return smp[:, n_per_chain // 4:].astype(np.float64)


def _check_moments(pf, name, sampler, skel, mean, var, n_per_chain=256):
    smp = _samples(pf, sampler, skel, n_per_chain)
    check(np.isfinite(smp).all(), f"{name}: non-finite samples")
    z_m, z_q = moment_z(smp, mean, var)
    check(z_m <= N_SE and z_q <= N_SE,
          f"{name}: moments off by {z_m:.2f} / {z_q:.2f} SE (limit {N_SE})")
    return z_m, z_q


def _events_run(pf, sampler, n_or_T, x0, v0, seed, **kw):
    """One timed ``pf.sample_skeleton`` call, synchronized on ``n_valid``
    (an output of the same program as the skeleton buffers)."""
    import jax
    import jax.numpy as jnp

    def go():
        skel = pf.sample_skeleton(sampler, n_or_T, x0, v0, seed=seed,
                                  dtype=jnp.float32, **kw)
        return skel, np.asarray(jax.device_get(skel.n_valid))

    (skel, nv), wall = _timed(go)
    return skel, nv, wall


def _warm_run(pf, sampler, n_or_T, x0, v0, seed, **kw):
    """Two untimed calls, then one timed: the first call compiles, the
    second compiles the fill width learned from the first run (adaptive
    fill sizing).  Returns ``(skel, n_valid, wall_s, first_call_s,
    second_call_s)``."""
    *_, first_s = _events_run(pf, sampler, n_or_T, x0, v0, seed, **kw)
    *_, second_s = _events_run(pf, sampler, n_or_T, x0, v0, seed + 1, **kw)
    skel, nv, wall = _events_run(pf, sampler, n_or_T, x0, v0, seed + 2,
                                 **kw)
    return skel, nv, wall, first_s, second_s


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(card: str, want_count: int = 1) -> dict:
    import jax

    from pdmpflux_tpu.core import capability

    devs = jax.devices()
    dev = devs[0]
    check(dev.platform == "gpu",
          f"default device is {dev.platform!r}, not a GPU")
    check(len(devs) >= want_count,
          f"need {want_count} GPUs, found {len(devs)}")
    path = capability.resolve()
    _report("device", card, platform=dev.platform, kind=repr(dev.device_kind),
            count=len(devs), path=path)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devs)}


def phase_flagship(card: str, B: int = 8192, n_sk: int = 2048,
                   dim: int = 10) -> dict:
    """ZigZag on the standard Gaussian, event-count mode."""
    import jax
    import pdmpflux_tpu as pf

    sampler = pf.ZigZag(dim, lambda x: x)  # grad of |x|^2 / 2
    x0, v0 = np.zeros((B, dim)), np.ones((B, dim))
    skel, nv, wall, first_s, second_s = _warm_run(pf, sampler, n_sk, x0,
                                                  v0, 0)
    check((nv == n_sk).all(), f"flagship: n_valid min {nv.min()} != {n_sk}")
    z_m, z_q = _check_moments(pf, "flagship", sampler, skel, 0.0, 1.0)
    chain0 = jax.tree.map(lambda a: np.asarray(a)[0], skel)
    one = np.asarray(pf.sample_from_skeleton(sampler, 1000, chain0))
    check(one.shape == (1000, dim) and np.isfinite(one).all(),
          "flagship: sample_from_skeleton on one chain")
    events = int(nv.sum()) - B
    _report("flagship", card, B=B, events_per_chain=n_sk - 1, wall_s=wall,
            events_per_s=events / wall, first_call_s=first_s,
            second_call_s=second_s, z_mean=z_m, z_var=z_q)
    t_end = np.asarray(skel.t)[np.arange(B), nv - 1]
    return {"events_per_s": events / wall, "t_end_median": float(
        np.median(t_end))}


def phase_horizon(card: str, B: int = 8192, T: float = 512.0,
                  dim: int = 10) -> dict:
    """Time-horizon mode at the flagship width; T = 512 gives ~2,000
    events per chain at the 10-d Gaussian's ~3.99 events per unit time."""
    import pdmpflux_tpu as pf

    sampler = pf.ZigZag(dim, lambda x: x)
    x0, v0 = np.zeros((B, dim)), np.ones((B, dim))
    skel, nv, wall, first_s, second_s = _warm_run(pf, sampler, T, x0, v0, 0)
    last = nv - 1
    rows = np.arange(B)
    t_end = np.asarray(skel.t)[rows, last]
    check((t_end == np.float32(T)).all(), "horizon: t[-1] != T")
    check((np.asarray(skel.kind)[rows, last] == pf.EV_TERMINAL).all(),
          "horizon: last row is not EV_TERMINAL")
    z_m, z_q = _check_moments(pf, "horizon", sampler, skel, 0.0, 1.0)
    events = int(nv.sum()) - 2 * B  # init and terminal rows are not events
    _report("horizon", card, B=B, T=T, mean_events_per_chain=events / B,
            wall_s=wall, events_per_s=events / wall, first_call_s=first_s,
            second_call_s=second_s, z_mean=z_m, z_var=z_q)
    return {"events_per_s": events / wall}


def family_rows(scale: int = 1):
    """The six other families at their ``benchmarks/run_baselines.py`` rows
    (chains, events per chain); ``scale`` divides both for tiny test runs."""
    import pdmpflux_tpu as pf
    from pdmpflux_tpu.utils import potentials

    sig = np.linspace(0.5, 3.0, 10)
    return [
        dict(name="bps_anisotropic_gauss_d10", B=512, n=8192,
             make=lambda: pf.BPSAD(10, potentials.anisotropic_gauss(sig),
                                   refresh_rate=0.5),
             var=sig ** 2),
        dict(name="boomerang_gauss_d10", B=512, n=1024,
             make=lambda: pf.Boomerang(10, lambda x: x, refresh_rate=0.5)),
        dict(name="rhmc_gauss_d10", B=512, n=1024,
             make=lambda: pf.RHMCAD(10, potentials.gauss, refresh_rate=1.0)),
        dict(name="ecmc_gauss_d10", B=512, n=2048, unit_speed=True,
             make=lambda: pf.ForwardECMCAD(10, potentials.gauss)),
        dict(name="suzz_gauss_d10", B=512, n=2048,
             make=lambda: pf.SpeedUpZigZagAD(10, potentials.gauss)),
        dict(name="sticky_zigzag_d100", B=128, n=16384, kappa=10.0,
             make=lambda: pf.StickyZigZagAD(100, potentials.gauss,
                                            np.full(100, 10.0))),
    ] if scale == 1 else [
        dict(r, B=max(8, r["B"] // scale), n=max(64, r["n"] // scale))
        for r in family_rows(1)
    ]


def phase_families(card: str, scale: int = 1) -> dict:
    import pdmpflux_tpu as pf

    out = {}
    for row in family_rows(scale):
        sampler = row["make"]()
        d, B, n = sampler.dim, row["B"], row["n"]
        x0 = np.full((B, d), 0.3 if "kappa" in row else 0.0)
        v0 = np.ones((B, d)) / (math.sqrt(d) if row.get("unit_speed") else 1)
        skel, nv, wall = _events_run(pf, sampler, n, x0, v0, 3)
        check((nv == n).all(), f"{row['name']}: n_valid min {nv.min()}")
        extra = {}
        if "kappa" in row:
            # spike-and-slab: spike mass phi(0) / (kappa + phi(0)); the
            # slab's second moment is (1 - spike)
            phi0 = 1.0 / math.sqrt(2 * math.pi)
            spike = phi0 / (row["kappa"] + phi0)
            smp = _samples(pf, sampler, skel, 256)
            observed = float((smp == 0.0).mean())
            slab_var = float(smp.var())
            check(abs(observed - spike) < SPIKE_TOL
                  and abs(slab_var - (1.0 - spike)) < SLAB_VAR_TOL,
                  f"{row['name']}: spike mass {observed:.4f} vs {spike:.4f}, "
                  f"variance {slab_var:.4f} vs {1.0 - spike:.4f}")
            z_m, z_q = moment_z(smp, 0.0, 1.0 - spike)
            extra = dict(spike_mass=observed, spike_theory=spike,
                         variance=slab_var)
        else:
            z_m, z_q = _check_moments(pf, row["name"], sampler, skel, 0.0,
                                      row.get("var", 1.0))
        _report(row["name"], card, B=B, events_per_chain=n - 1,
                wall_incl_compile_s=wall, z_mean=z_m, z_var=z_q, **extra)
        out[row["name"]] = (z_m, z_q)
    return out


def phase_large_state(card: str, B: int = 128, n_sk: int = 2048,
                      dim: int = 1000, T_stream: float = 64.0) -> dict:
    """StickyZigZag at d=1000 (gather compaction), then streaming
    statistics at d=1000 over a few fills."""
    import pdmpflux_tpu as pf
    from pdmpflux_tpu.utils import potentials

    def make():
        return pf.StickyZigZagAD(dim, potentials.gauss, np.full(dim, 10.0))

    x0, v0 = np.full((B, dim), 0.3), np.ones((B, dim))
    sampler = make()
    skel, nv, wall, first_s, second_s = _warm_run(pf, sampler, n_sk, x0,
                                                  v0, 0)
    check((nv == n_sk).all(), f"sticky d={dim}: n_valid min {nv.min()}")
    kind = np.asarray(skel.kind)
    t = np.asarray(skel.t)
    check(np.isfinite(np.asarray(skel.x)).all(), "sticky: non-finite x")
    check((np.diff(t, axis=1) >= 0).all(), "sticky: non-monotone times")
    check((kind == pf.EV_STICK).any(), "sticky: no stick events")
    events = int(nv.sum()) - B
    _report(f"sticky_d{dim}", card, B=B, events_per_chain=n_sk - 1,
            wall_s=wall, events_per_s=events / wall, first_call_s=first_s,
            second_call_s=second_s)

    run, swall = _timed(lambda: pf.sample_streaming_stats(
        make(), T_stream, x0, v0, n_samples=1024, n_batches=16, seed=2,
        dtype=np.float32))
    summ = pf.streaming_summary(run)
    check(math.isfinite(summ["rhat_max"]), "streaming: R-hat not finite")
    check(np.isfinite(summ["pooled_mean"]).all(), "streaming: mean")
    _report(f"streaming_d{dim}", card, B=B, T=T_stream, fills=run.fills,
            events=run.events, wall_incl_compile_s=swall,
            events_per_s_incl_compile=run.events / swall,
            rhat_max=summ["rhat_max"])
    return {"events_per_s": events / wall}


def _first_events_agree(a, b):
    """Per-chain agreement of the first AGREE_EVENTS events (plus the
    initial record) of two chain-batch skeletons."""
    k = AGREE_EVENTS + 1
    ok = np.ones(np.shape(a.t)[0], bool)
    for f in ("t", "x", "v"):
        fa = np.asarray(getattr(a, f))[:, :k]
        fb = np.asarray(getattr(b, f))[:, :k]
        close = np.abs(fa - fb) <= AGREE_RTOL * np.abs(fb) + 1e-30
        ok &= close.reshape(close.shape[0], -1).all(axis=1)
    ok &= (np.asarray(a.kind)[:, :k] == np.asarray(b.kind)[:, :k]).all(axis=1)
    return ok


def _compaction_bit_equal(sampler, B, dim, t_cap, target, x0, v0):
    """Run one raw stream fill on the device and compact it with both
    formulations; every field must match bit for bit."""
    import jax
    import jax.numpy as jnp

    from pdmpflux_tpu.core import engine

    state = sampler.init_state_batch(x0, v0, 5, jnp.float32)
    run = jax.jit(engine.make_stream_runner(sampler, t_cap, chunk=64),
                  static_argnums=(3,))
    res = run(state, engine.empty_stream(t_cap, dim, jnp.float32, B),
              jnp.zeros((B,), jnp.int32), target)
    a = jax.jit(engine._compact_rows_logshift, static_argnums=(1,))(
        res.stream, target)
    b = jax.jit(engine._compact_rows_gather, static_argnums=(1,))(
        res.stream, target)
    for f in engine.Skeleton._fields:
        if f != "n_valid":
            check(np.array_equal(np.asarray(getattr(a, f)),
                                 np.asarray(getattr(b, f))),
                  f"compaction d={dim}: field {f} differs")


def phase_reference(card: str, B: int = 8192, n_sk: int = 2048,
                    dim: int = 10, B_large: int = 128,
                    dim_large: int = 1000) -> dict:
    """Stream recorder vs the plain scatter recorder on the same seed, at
    the flagship shape and at d=1000, with both timed warm."""
    import pdmpflux_tpu as pf
    from pdmpflux_tpu.utils import potentials

    out = {}
    shapes = [
        ("flagship", lambda: pf.ZigZag(dim, lambda x: x), B, dim,
         np.zeros((B, dim))),
        (f"sticky_d{dim_large}",
         lambda: pf.StickyZigZagAD(dim_large, potentials.gauss,
                                   np.full(dim_large, 10.0)),
         B_large, dim_large, np.full((B_large, dim_large), 0.3)),
    ]
    for name, make, b, d, x0 in shapes:
        v0 = np.ones((b, d))
        runs = {}
        for backend in ("xla", "xla_stream"):
            sampler = make()
            skel, nv, wall, *_ = _warm_run(pf, sampler, n_sk, x0, v0, 7,
                                           backend=backend)
            check((nv == n_sk).all(), f"{name}/{backend}: n_valid")
            runs[backend] = (skel, wall)
        agree = _first_events_agree(runs["xla_stream"][0], runs["xla"][0])
        check(agree.all(), f"{name}: {int((~agree).sum())} of {b} chains "
              f"differ within the first {AGREE_EVENTS} events")
        ev = b * (n_sk - 1)
        t_scatter, t_stream = runs["xla"][1], runs["xla_stream"][1]
        target = n_sk - 1
        t_cap = -(-int(target * 1.8 + 64) // 256) * 256
        _compaction_bit_equal(make(), b, d, t_cap, target, x0, v0)
        _report(f"reference_{name}", card, B=b, events_per_chain=target,
                scatter_s=t_scatter, stream_s=t_stream,
                scatter_events_per_s=ev / t_scatter,
                stream_events_per_s=ev / t_stream,
                chains_agreeing=f"{int(agree.sum())}/{b}",
                compaction="bit-equal")
        out[name] = {"scatter_s": t_scatter, "stream_s": t_stream}
    return out


def phase_four(card: str, B_per: int = 8192, n_sk: int = 2048,
               dim: int = 10, n_dev: int = 4) -> dict:
    """The chain-sharded path: ``sample_skeleton_sharded`` over an
    ``n_dev``-device ``chains`` mesh against the same chains on one
    device, then one sharded streaming run."""
    import jax
    import jax.numpy as jnp
    import pdmpflux_tpu as pf

    devs = jax.devices()[:n_dev]
    check(len(devs) == n_dev, f"need {n_dev} devices, found {len(devs)}")
    B = B_per * n_dev
    x0, v0 = np.zeros((B, dim)), np.ones((B, dim))
    runs = {}
    for label, mesh in (
        ("one_device", pf.parallel.make_mesh(1, 1, devices=devs[:1])),
        (f"{n_dev}_devices", pf.parallel.make_mesh(n_dev, 1, devices=devs)),
    ):
        sampler = pf.ZigZag(dim, lambda x: x)

        def go():
            r = pf.parallel.sample_skeleton_sharded(
                sampler, n_sk, x0, v0, mesh=mesh, seed=3, dtype=jnp.float32)
            return r, np.asarray(jax.device_get(r.skeleton.n_valid))

        _timed(go)  # compile
        _timed(go)  # compile the learned fill width
        (run, nv), wall = _timed(go)
        check((nv == n_sk).all(), f"sharded {label}: n_valid")
        shard_devs = sorted({str(s.device)
                             for s in run.skeleton.x.addressable_shards})
        runs[label] = (run, wall, shard_devs)
        _report(f"sharded_{label}", card, B=B, events_per_chain=n_sk - 1,
                wall_s=wall, events_per_s=B * (n_sk - 1) / wall,
                shard_devices=shard_devs)
    sharded = runs[f"{n_dev}_devices"]
    check(len(sharded[2]) == n_dev,
          f"shards landed on {sharded[2]}, not {n_dev} devices")
    agree = _first_events_agree(sharded[0].skeleton,
                                runs["one_device"][0].skeleton)
    check(agree.all(), f"sharded: {int((~agree).sum())} of {B} chains "
          f"differ within the first {AGREE_EVENTS} events")
    z_m, z_q = _check_moments(pf, "sharded", pf.ZigZag(dim, lambda x: x),
                              sharded[0].skeleton, 0.0, 1.0)
    mesh = pf.parallel.make_mesh(n_dev, 1, devices=devs)
    srun, swall = _timed(lambda: pf.sample_streaming_stats(
        pf.ZigZag(dim, lambda x: x), 256.0, x0, v0, n_samples=1024,
        n_batches=16, seed=4, dtype=jnp.float32, mesh=mesh))
    summ = pf.streaming_summary(srun)
    check(summ["converged"], f"sharded streaming: rhat {summ['rhat_max']}")
    check(np.abs(summ["pooled_mean"]).max() < 0.05
          and np.abs(summ["pooled_var"] - 1.0).max() < 0.05,
          "sharded streaming: pooled moments")
    stat_devs = sorted({str(s.device)
                        for s in srun.stats.sum_half.addressable_shards})
    check(len(stat_devs) == n_dev, f"streaming stats on {stat_devs}")
    _report("sharded_streaming", card, B=B, T=256.0, fills=srun.fills,
            events=srun.events, wall_incl_compile_s=swall,
            rhat_max=summ["rhat_max"], stat_devices=stat_devs)
    one_s, many_s = runs["one_device"][1], sharded[1]
    _report("sharded_scaling", card, speedup=one_s / many_s,
            efficiency=one_s / many_s / n_dev, chains_agreeing=f"{B}/{B}",
            z_mean=z_m, z_var=z_q)
    return {"speedup": one_s / many_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the chain-sharded path on four GPUs")
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; default device is "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        return 2

    from pdmpflux_tpu.utils.profiling import enable_persistent_cache

    print(f"compile cache: {enable_persistent_cache()}", flush=True)
    card = card_info()
    want = 4 if args.four else 1
    device = phase_device(card, want_count=want)
    t0 = time.perf_counter()
    if args.four:
        phase_four(card)
    else:
        phase_flagship(card)
        phase_horizon(card)
        phase_families(card)
        phase_large_state(card)
        phase_reference(card)
    print(f"card: {card}", flush=True)
    print(f"total_s={time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
