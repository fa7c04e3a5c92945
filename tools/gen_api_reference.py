"""Generate a markdown API reference from the package's docstrings.

The reference ships a full sphinx API reference (``/root/reference/docs/api.rst``
and friends); this repo has no sphinx dependency, so the reference is a
scripted docstring dump: one page per public module under ``docs/api/``,
plus an index. Regenerate with::

    python tools/gen_api_reference.py

The output is deterministic (sorted members, no timestamps) so the generated
files are committed and diffs show real API changes.
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Force CPU before anything initializes a backend: this script only
# introspects docstrings and must never contend with a benchmark for the
# card.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

MODULES = [
    # (module, one-line section description)
    ("tdgl_tpu", "Top-level exports"),
    ("tdgl_tpu.geometry", "Geometry primitives (box, circle, ellipse, ...)"),
    ("tdgl_tpu.distance", "Pairwise distance helpers"),
    ("tdgl_tpu.em", "Electromagnetics (Biot-Savart, field conversion)"),
    ("tdgl_tpu.utils.units", "Unit registry and conversion engine"),
    ("tdgl_tpu.device.layer", "Layer: material parameters"),
    ("tdgl_tpu.device.polygon", "Polygon: geometry with set operations"),
    ("tdgl_tpu.device.device", "Device: the problem specification"),
    ("tdgl_tpu.device.meshing", "Unstructured mesh generation"),
    ("tdgl_tpu.device.hexmesh", "Structured (lattice) mesh generation"),
    ("tdgl_tpu.device.cutcell", "Cut-cell boundary corrections"),
    ("tdgl_tpu.device.clipping", "Polygon boolean engine"),
    ("tdgl_tpu.fv.mesh", "Mesh: triangulation + Voronoi dual"),
    ("tdgl_tpu.fv.edge_mesh", "EdgeMesh: edge-centric mesh view"),
    ("tdgl_tpu.fv.util", "Voronoi / mesh utilities"),
    ("tdgl_tpu.fv.operators", "Finite-volume operators (ELL form)"),
    ("tdgl_tpu.fv.stencil_operators", "Finite-volume operators (stencil form)"),
    ("tdgl_tpu.parameter", "Parameter: user-supplied physics inputs"),
    ("tdgl_tpu.sources", "Prebuilt field sources"),
    ("tdgl_tpu.solver.options", "SolverOptions"),
    ("tdgl_tpu.solver.solve", "solve() facade"),
    ("tdgl_tpu.solver.solver", "TDGLSolver"),
    ("tdgl_tpu.solver.runner", "Runner and DataHandler"),
    ("tdgl_tpu.models.gtdgl", "gTDGL equations (ELL / unstructured)"),
    ("tdgl_tpu.models.gtdgl_stencil", "gTDGL equations (stencil / structured)"),
    ("tdgl_tpu.ops.cg", "Linear solvers (CG, MG-Richardson)"),
    ("tdgl_tpu.ops.hexmg", "Structured multigrid hierarchy"),
    ("tdgl_tpu.ops.amg", "Unstructured algebraic multigrid"),
    ("tdgl_tpu.ops.screening", "Pairwise screening kernels"),
    ("tdgl_tpu.ops.fft_screening", "FFT screening convolution"),
    ("tdgl_tpu.solution.solution", "Solution: post-processing"),
    ("tdgl_tpu.solution.data", "TDGLData / DynamicsData"),
    ("tdgl_tpu.solution.plot_solution", "Publication plotting"),
    ("tdgl_tpu.fluxoid", "Fluxoid utilities"),
    ("tdgl_tpu.parallel.sweep", "Device-sharded parameter sweeps"),
    ("tdgl_tpu.parallel.spatial", "Single-problem spatial sharding"),
    ("tdgl_tpu.parallel.fft_sharded", "Pencil-decomposed sharded FFT"),
    ("tdgl_tpu.visualization", "Visualization API"),
    ("tdgl_tpu.visualize", "Command-line interface"),
    ("tdgl_tpu.about", "Environment introspection"),
    ("tdgl_tpu.testing", "Self-test entry point"),
]


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for name in sorted(names):
        obj = getattr(mod, name, None)
        if obj is None:
            continue
        if inspect.ismodule(obj):
            continue
        # Skip re-exports that aren't defined or documented here, except in
        # aggregator modules (top-level package, subpackage __init__).
        mod_name = getattr(obj, "__module__", mod.__name__)
        is_aggregator = mod.__name__.count(".") < 2 or (
            getattr(mod, "__file__", "") or "").endswith("__init__.py")
        if not is_aggregator and mod_name != mod.__name__:
            continue
        if not (mod_name or "").startswith("tdgl_tpu"):
            continue
        out.append((name, obj))
    return out


def _signature(obj) -> str:
    import re

    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    # Object-default reprs carry memory addresses; scrub them so the
    # output stays deterministic across runs.
    return re.sub(r" at 0x[0-9a-f]+", "", sig)


def _doc(obj) -> str:
    doc = inspect.getdoc(obj)
    return doc.strip() if doc else "*(no docstring)*"


def _class_section(name, cls) -> list:
    lines = [f"### `{name}{_signature(cls)}`", "", _doc(cls), ""]
    for mname, member in sorted(vars(cls).items()):
        if mname.startswith("_"):
            continue
        if isinstance(member, (staticmethod, classmethod)):
            member = member.__func__
        if callable(member):
            lines += [f"#### `{name}.{mname}{_signature(member)}`", "",
                      _doc(member), ""]
        elif isinstance(member, property):
            lines += [f"#### `{name}.{mname}` *(property)*", "",
                      _doc(member), ""]
    return lines


def main() -> None:
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "api")
    os.makedirs(out_dir, exist_ok=True)
    index = [
        "# API reference",
        "",
        "Generated from docstrings by `tools/gen_api_reference.py`"
        " — regenerate after changing public APIs.",
        "",
        "| Module | Description |",
        "|---|---|",
    ]
    for mod_name, desc in MODULES:
        mod = importlib.import_module(mod_name)
        page = mod_name.replace(".", "_") + ".md"
        index.append(f"| [`{mod_name}`]({page}) | {desc} |")
        lines = [f"# `{mod_name}`", "", _doc(mod), ""]
        for name, obj in _public_members(mod):
            if inspect.isclass(obj):
                lines += _class_section(name, obj)
            elif callable(obj):
                lines += [f"### `{name}{_signature(obj)}`", "", _doc(obj), ""]
            else:
                lines += [f"### `{name}`", "",
                          f"*(constant, type `{type(obj).__name__}`)*", ""]
        with open(os.path.join(out_dir, page), "w") as f:
            f.write("\n".join(lines).rstrip() + "\n")
        print(f"wrote docs/api/{page}")
    with open(os.path.join(out_dir, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print("wrote docs/api/index.md")


if __name__ == "__main__":
    main()
