"""Execution-path resolver: the one place that maps the default device to
the recorder and driver choices made by ``api``, ``streaming`` and
``parallel.sharded``.

* **GPU** — the scatter-free stream recorder (``engine.make_stream_runner``)
  with the fused one-shot program, adaptive fill sizing and eight stream
  fills per streaming dispatch.
* **CPU** — the per-chunk scatter recorder (``engine._make_chunk_runner``),
  whose single geometry keeps test compile cost low.
* Any other platform raises: nothing is assumed about a device this code
  has not been run on.

Three environment flags adjust the record (read here and nowhere else):
``PDMPFLUX_FORCE_STREAM=1`` selects the stream recorder,
``PDMPFLUX_TEST_ONE_SHOT=1`` enables the fused one-shot program and
``PDMPFLUX_STREAM_HOST_ACC=1`` makes stream runs accumulate events on the
host.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax


@dataclasses.dataclass(frozen=True)
class ExecPath:
    recorder: str            # "stream" | "scatter"
    one_shot: bool           # init + fill + compaction as one program
    fills_per_dispatch: int  # streaming fills scanned per dispatch
    adaptive_fill: bool      # size fills from the last completed run
    host_acc: bool = False   # stream runs accumulate events on the host


GPU_PATH = ExecPath(recorder="stream", one_shot=True, fills_per_dispatch=8,
                    adaptive_fill=True)
CPU_PATH = ExecPath(recorder="scatter", one_shot=False, fills_per_dispatch=2,
                    adaptive_fill=False)


def path_for(platform: str) -> ExecPath:
    """The execution path for a device platform (``jax.Device.platform``),
    with the environment flags of the module docstring applied."""
    if platform == "gpu":
        path = GPU_PATH
    elif platform == "cpu":
        path = CPU_PATH
    else:
        raise RuntimeError(
            f"pdmpflux has no execution path for platform {platform!r}; "
            "supported platforms are 'gpu' and 'cpu'"
        )
    env = os.environ
    if env.get("PDMPFLUX_FORCE_STREAM", "") == "1":
        path = dataclasses.replace(path, recorder="stream")
    if env.get("PDMPFLUX_TEST_ONE_SHOT", "") == "1":
        path = dataclasses.replace(path, one_shot=True)
    if env.get("PDMPFLUX_STREAM_HOST_ACC", "") == "1":
        path = dataclasses.replace(path, host_acc=True)
    return path


@functools.cache
def resolve() -> ExecPath:
    """The execution path of the default device, decided once per
    process."""
    return path_for(jax.devices()[0].platform)
