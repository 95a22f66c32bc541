"""End-to-end public-API throughput: pf.sample_skeleton on the flagship
config (ZigZag, 10-d Gaussian, B=4096, n_sk=2048) — the number a user
actually gets, fill + compaction + assembly included."""
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

    from pdmpflux_tpu.utils.profiling import enable_persistent_cache

    enable_persistent_cache()
    import jax.numpy as jnp

    import pdmpflux_tpu as pf

    B = int(os.environ.get("E2E_B", 4096))
    n_sk = int(os.environ.get("E2E_N", 2048))
    dim = 10
    x0, v0 = np.zeros((B, dim)), np.ones((B, dim))

    sampler = pf.ZigZag(dim, lambda x: x)
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
              f"{events / wall / 1e6:.2f} M events/s", flush=True)
    print(f"BEST public-API rate: {events / best / 1e6:.2f} M events/s",
          flush=True)


if __name__ == "__main__":
    main()
