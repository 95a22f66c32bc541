"""Probe: dim-1000 sticky flagship end to end through pf.sample_skeleton
(B=128, 2,048 events per chain; override with S1000_B / S1000_N).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _force_scalar(a):
    """Force device materialization by reducing ON DEVICE and fetching one
    scalar instead of the whole ``t`` array."""
    import jax.numpy as _jnp

    if isinstance(a, np.ndarray):
        return float(a.reshape(-1)[-1])
    return float(_jnp.max(a))



def main():
    import jax
    import jax.numpy as jnp

    import pdmpflux_tpu as pf
    from pdmpflux_tpu.utils.profiling import enable_persistent_cache
    from pdmpflux_tpu.utils import potentials

    enable_persistent_cache()

    dim = 1000
    B = int(os.environ.get("S1000_B", 128))
    n_sk = int(os.environ.get("S1000_N", 2048))
    kappa = np.full(dim, 10.0)

    sampler = pf.StickyZigZagAD(dim, potentials.gauss, kappa)

    x0 = np.full((B, dim), 0.3)
    v0 = np.ones((B, dim))
    kw = dict(dtype=jnp.float32, backend="auto")

    def once(seed):
        t0 = time.perf_counter()
        skel = pf.sample_skeleton(sampler, n_sk, x0, v0, seed=seed, **kw)
        nv = np.asarray(jax.device_get(skel.n_valid))
        _force_scalar(skel.t)
        wall = time.perf_counter() - t0
        return skel, wall, int(nv.sum()) - B

    print("compiling...", flush=True)
    t0 = time.perf_counter()
    once(0)
    print(f"compile+first run: {time.perf_counter() - t0:.1f} s", flush=True)
    best = float("inf")
    for rep in (1, 2):
        skel, wall, events = once(rep)
        best = min(best, wall)
        print(f"rep: {events} events in {wall:.3f} s = "
              f"{events / wall / 1e3:.1f} k events/s", flush=True)
    kind = np.asarray(skel.kind)
    print(f"BEST: {events / best / 1e3:.1f} k events/s "
          f"(r2 XLA baseline 442k); stick={int((kind == 3).sum())} "
          f"thaw={int((kind == 4).sum())}", flush=True)


if __name__ == "__main__":
    main()
