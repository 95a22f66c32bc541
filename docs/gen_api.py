"""Generate ``docs/api.md`` — the rendered API reference.

The reference's Documenter site renders every exported docstring
(``/root/reference/docs/make.jl:10-23``); this is the equivalent for
pdmpflux_tpu, kept dependency-free (no mkdocstrings available offline):
walk the public surface, emit each signature + docstring as markdown.

Run ``python docs/gen_api.py`` to regenerate;
``tests/test_docs.py::test_api_reference_in_sync`` asserts the committed
page matches the code, and the docs CI job regenerates it before building.
"""

from __future__ import annotations

import inspect
import os
import sys
import textwrap

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SECTIONS = [
    ("Drivers", "pdmpflux_tpu.api",
     ["sample", "sample_skeleton", "sample_from_skeleton",
      "sample_skeleton_with_diagnostic"]),
    ("Samplers", "pdmpflux_tpu.models",
     ["PDMP", "ZigZag", "ZigZagAD", "BPS", "BPSAD", "Boomerang",
      "BoomerangAD", "ForwardECMC", "ForwardECMCAD", "RHMC", "RHMCAD",
      "SpeedUpZigZag", "SpeedUpZigZagAD", "StickyZigZag", "StickyZigZagAD"]),
    ("Core types", "pdmpflux_tpu.core.types",
     ["PDMPState", "Skeleton", "Event", "BoundBox"]),
    ("Diagnostics", "pdmpflux_tpu.diagnostics",
     ["diagnostic", "RV_diagnostic", "ess", "ess_per_dim", "ess_nd",
      "split_rhat", "ess_summary"]),
    ("Plotting", "pdmpflux_tpu.plotting",
     ["plot_traj", "jointplot", "marginalplot", "plot_U_contour",
      "anim_traj", "anim_traj_"]),
    ("Parallel / sharding", "pdmpflux_tpu.parallel.sharded",
     ["sample_skeleton_sharded", "sample_from_skeleton_batch",
      "pooled_moments"]),
    ("Parallel / mesh & multi-host", "pdmpflux_tpu.parallel",
     ["make_mesh"]),
    ("Checkpointing", "pdmpflux_tpu.parallel.checkpoint",
     ["save_checkpoint", "load_checkpoint"]),
    ("Profiling", "pdmpflux_tpu.utils.profiling",
     ["timed", "trace", "annotate", "enable_persistent_cache"]),
    ("Execution path", "pdmpflux_tpu.core.capability",
     ["ExecPath", "path_for", "resolve"]),
    ("Engine", "pdmpflux_tpu.core.engine",
     ["make_transition", "make_stream_runner", "make_fixed_event_runner",
      "make_horizon_runner", "compact_stream_rows"]),
    ("Bounds (thinning envelopes)", "pdmpflux_tpu.core.bounds",
     ["upper_bound_grid", "upper_bound_grid_vect", "upper_bound_constant",
      "next_event"]),
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _doc(obj) -> str:
    doc = inspect.getdoc(obj) or "*(undocumented)*"
    return doc.strip()


def render() -> str:
    import importlib

    out = [
        "# API reference",
        "",
        "*Generated from docstrings by `docs/gen_api.py` — do not edit by "
        "hand.  The reference analogue is the Documenter site rendering "
        "every exported docstring (`/root/reference/docs/make.jl:10-23`).*",
        "",
    ]
    for title, modname, names in SECTIONS:
        mod = importlib.import_module(modname)
        out += [f"## {title}", "", f"Module `{modname}`", ""]
        for name in names:
            obj = getattr(mod, name)
            if inspect.isclass(obj):
                out.append(f"### `{name}{_sig(obj)}`")
                out += ["", _doc(obj), ""]
                for mname, meth in sorted(vars(obj).items()):
                    if mname.startswith("_") or not callable(meth):
                        continue
                    if not (inspect.isfunction(meth) or isinstance(
                            meth, (classmethod, staticmethod))):
                        continue
                    fn = meth.__func__ if isinstance(
                        meth, (classmethod, staticmethod)) else meth
                    if not fn.__doc__:
                        continue
                    out.append(f"#### `{name}.{mname}{_sig(fn)}`")
                    out += ["", _doc(fn), ""]
            elif callable(obj):
                out.append(f"### `{name}{_sig(obj)}`")
                out += ["", _doc(obj), ""]
            else:
                out.append(f"### `{name}`")
                out += ["", _doc(type(obj)) if _doc(type(obj)) else "", ""]
    text = "\n".join(out).rstrip() + "\n"
    return text


def main():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "api.md")
    with open(path, "w") as f:
        f.write(render())
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
