"""ECMC envelope-tightness sweep (VERDICT r4 item 6).

The r4 sweep measured ``ecmc_gauss_d10`` acceptance at 0.889 — lowest of
the non-sticky family — meaning ~11% of gradient evaluations are thinning
waste.  For the Gaussian the rate along the flow is LINEAR in t, so the
grid envelope's per-segment constant (max of endpoints + tangent
intersection) is exact at the segment ends; the slack is simply the
segment WIDTH (horizon / grid_size).  This sweep measures acceptance and
events/s over (tmax, grid_size) to pick defaults that hit >= 0.95
acceptance without losing throughput.

Run on the GPU; prints one JSON line per configuration.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _log(msg):
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def main():
    import jax

    from pdmpflux_tpu.utils.profiling import enable_persistent_cache

    enable_persistent_cache()
    import jax.numpy as jnp

    import pdmpflux_tpu as pf
    from pdmpflux_tpu.utils import potentials

    dim, B, n_ev = 10, 512, 2048
    x0 = np.zeros((B, dim))
    v0 = np.ones((B, dim)) / np.sqrt(dim)
    kw = dict(dtype=jnp.float32, backend="auto")

    import os as _os
    grids = [(2.0, 10), (1.0, 10), (0.6, 10), (2.0, 20), (1.0, 16),
             (0.5, 8), (0.4, 10)]
    if _os.environ.get("ECMC_GRIDS"):
        grids = [tuple(map(float, g.split(":")))
                 for g in _os.environ["ECMC_GRIDS"].split(",")]
        grids = [(t, int(g)) for t, g in grids]
    results = []
    for tmax, gs in grids:
        smp = pf.ForwardECMCAD(dim, potentials.gauss, tmax=tmax,
                               grid_size=gs)
        _log(f"tmax={tmax} grid={gs}: warmup...")

        def run(seed):
            t0 = time.perf_counter()
            skel = pf.sample_skeleton(smp, n_ev, x0, v0, seed=seed, **kw)
            nv = np.asarray(jax.device_get(skel.n_valid))
            float(jnp.max(skel.t))
            return skel, time.perf_counter() - t0, int(nv.sum()) - B

        run(0)
        run(0)
        skel, w1, e1 = run(1)
        skel2, w2, e2 = run(2)
        if e2 / w2 > e1 / w1:
            skel, w1, e1 = skel2, w2, e2
        ar = np.asarray(skel.ar)[np.asarray(skel.kind) == pf.EV_JUMP]
        from pdmpflux_tpu.parallel.sharded import pooled_moments

        mean, var = pooled_moments(skel, smp, 1024)
        row = {
            "tmax": tmax, "grid_size": gs,
            "events_per_sec": round(e1 / w1, 1),
            "mean_acceptance": round(float(ar.mean()), 4),
            "moment_mean_err_max": round(
                float(np.abs(np.asarray(mean)).max()), 4),
            "moment_var_relerr_max": round(
                float(np.abs(np.asarray(var) - 1.0).max()), 4),
        }
        print(json.dumps(row), flush=True)
        results.append(row)
        del skel, skel2, smp
        import gc

        gc.collect()

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "ecmc_envelope_sweep.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    _log(f"wrote {out}")


if __name__ == "__main__":
    main()
