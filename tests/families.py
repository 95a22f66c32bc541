"""The seven sampler families on the 3-d standard Gaussian, with their
analytic stationary moments — shared by the recorder-parity and stream-law
tests."""

import numpy as np

import pdmpflux_tpu as pf

DIM = 3
KAPPA = 1.0
# sticky ZigZag targets spike-and-slab: per-coordinate spike mass
# phi(0) / (kappa + phi(0)) with phi the N(0, 1) density
SPIKE = (1.0 / np.sqrt(2 * np.pi)) / (KAPPA + 1.0 / np.sqrt(2 * np.pi))

FAMILIES = {
    "zigzag": lambda: pf.ZigZag(DIM, lambda x: x),
    "bps": lambda: pf.BPS(DIM, lambda x: x, refresh_rate=0.5),
    "boomerang": lambda: pf.Boomerang(DIM, lambda x: x, refresh_rate=0.5),
    "ecmc": lambda: pf.ForwardECMC(DIM, lambda x: x),
    "rhmc": lambda: pf.RHMC(DIM, lambda x: x, refresh_rate=1.0),
    "suzz": lambda: pf.SpeedUpZigZag(DIM, lambda x: x),
    "sticky": lambda: pf.StickyZigZag(DIM, lambda x: x,
                                      np.full(DIM, KAPPA)),
}

# stationary (mean, variance) per coordinate
TRUTH = {name: (0.0, 1.0) for name in FAMILIES}
TRUTH["sticky"] = (0.0, 1.0 - SPIKE)


def inits(name, B):
    x0 = np.full((B, DIM), 0.3 if name == "sticky" else 0.0)
    v0 = np.ones((B, DIM))
    if name == "ecmc":
        v0 = v0 / np.sqrt(DIM)  # unit speed, as the reference's ECMC config
    return x0, v0
