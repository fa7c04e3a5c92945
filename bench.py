"""Benchmark: TDGL steps/second on a 50k-site mesh (one GPU).

Measures simulation steps per wall-clock second — the quantity the
reference logs in its runner (``tdgl/solver/runner.py:386-395``) — on the
workload from BASELINE.md: a 50k-site structured film in a 0.5 mT field
with the adaptive time step active, unscreened and screened. Each mode runs
in its own child process, one after the other, so that one process at a
time holds the card; the parent never imports jax.

Prints exactly one JSON line:
    {"metric": ..., "value": N, "unit": "steps/sec", "device": {...},
     "card": "<name>, <power limit>", "provenance": {...}}

A run without a GPU fails: there is no CPU fallback.
"""

import json
import os
import subprocess
import sys
import time

# Steps fused per dispatch.
CHUNK = int(os.environ.get("TDGL_BENCH_CHUNK", "16000"))


def build_device(target_sites: int = 50_000, structured: bool = True):
    import numpy as np

    import tdgl_tpu as tdgl
    from tdgl_tpu.geometry import box

    layer = tdgl.Layer(
        coherence_length=1.0, london_lambda=2.0, thickness=0.1,
        conductivity=10.0,
    )
    # Side length scaled so ~target_sites at max_edge_length=0.75
    # (measured density: ~0.238 um^2/site on this workload).
    side = float(np.sqrt(target_sites * 0.238))
    film = tdgl.Polygon("film", points=box(side)).resample(
        max(200, int(11 * side))
    )
    device = tdgl.Device("bench", layer=layer, film=film, length_units="um")
    device.make_mesh(min_points=target_sites, max_edge_length=0.75,
                     structured=structured)
    return device


def _options(screened: bool):
    import tdgl_tpu as tdgl

    kwargs = {}
    ptol = os.environ.get("TDGL_BENCH_PTOL")
    if ptol:
        kwargs.update(poisson_tolerance=float(ptol))
    fold = os.environ.get("TDGL_BENCH_FOLD")
    if fold:  # "0"/"1" force the folded-link-weight fast path
        kwargs.update(fold_link_weights=bool(int(fold)))
    factor = os.environ.get("TDGL_BENCH_FACTOR")
    if factor:  # "0"/"1" force the factored (rank-structured) link phases
        kwargs.update(factor_link_phases=bool(int(factor)))
    failover = os.environ.get("TDGL_BENCH_FAILOVER")
    if failover:  # "0" disables the fast-chunk/failover program
        kwargs.update(chunk_failover=("auto" if int(failover) else "off"))
    unroll = os.environ.get("TDGL_BENCH_UNROLL")
    if unroll:  # scan unroll factor (None = auto)
        kwargs.update(scan_unroll=int(unroll))
    chunk = min(CHUNK, 4000) if screened else CHUNK
    if screened:
        inner = os.environ.get("TDGL_BENCH_SCREEN_INNER")
        kwargs.update(
            include_screening=True, screening_tolerance=1e-3,
            screening_cg_iterations=(int(inner) if inner else None),
        )
    return tdgl.SolverOptions(
        solve_time=1e9,           # run by step count, not simulation time
        dt_init=1e-4, dt_max=1e-2,
        save_every=chunk, steps_per_chunk=chunk,
        field_units="mT", current_units="uA", dtype="float32",
        **kwargs,
    )


def measure(target_sites: int, screened: bool) -> dict:
    """Build the workload and time it; returns the result dict.

    The timed window is pinned in steps and repeated 3x from the same
    post-warmup state (arrays are immutable, so each repetition replays the
    same trajectory); the median is reported. The in-program cumulative
    step counter proves every timed step ran.
    """
    import jax
    import numpy as np

    from tdgl_tpu.solver.solver import TDGLSolver
    from tdgl_tpu.utils.jaxio import to_numpy, tree_to_numpy

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench.py needs an NVIDIA GPU; jax found"
                         f" {devices[0].platform!r}")
    device_info = {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)}
    t_setup = time.perf_counter()
    device = build_device(target_sites)
    n_sites = len(device.mesh.sites)
    print(f"# mesh: {n_sites} sites ({time.perf_counter() - t_setup:.1f}s)",
          file=sys.stderr)
    solver = TDGLSolver(device, _options(screened),
                        applied_vector_potential=0.5)
    state = solver._initial_state()
    chunk = solver.chunk_size

    t0 = time.perf_counter()
    for _ in range(2):
        state, outputs, exported_dev = solver.chunk_fn(state)
    jax.block_until_ready(state)
    warmup_s = time.perf_counter() - t0
    diag = tree_to_numpy(exported_dev)["diagnostics"]
    assert np.isfinite(diag).all() and not bool(diag[5]), "warmup failed"

    state_w = state
    steps_before = int(diag[3])
    window = 4000 if screened else 32000
    n_chunks = max(2, window // chunk)
    steps = n_chunks * chunk
    reps = []
    for _rep in range(3):
        state = state_w
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            state, outputs, exported_dev = solver.chunk_fn(state)
        jax.block_until_ready(state)
        reps.append(time.perf_counter() - t0)
    exported = tree_to_numpy(exported_dev)
    diag = exported["diagnostics"]
    assert not bool(diag[5]), "solver failed during bench"
    executed = int(diag[3]) - steps_before
    assert executed == steps, f"only {executed}/{steps} timed steps ran"
    elapsed = sorted(reps)[len(reps) // 2]
    psi_abs = np.sqrt(exported["psi_real"]**2 + exported["psi_imag"]**2)
    psi_abs = solver.maps.grid_to_site(psi_abs)
    assert psi_abs.min() < 0.9, "no vortices: not exercising dynamics"
    return {
        "sites": n_sites, "screened": screened,
        "steps_per_sec": steps / elapsed, "steps": steps,
        "reps_s": reps, "warmup_s": warmup_s, "chunk": chunk,
        "mean_cg_iters": float(np.mean(to_numpy(outputs.cg_iterations))),
        "mean_screening_iters": float(np.mean(to_numpy(
            outputs.screening_iterations))),
        "failovers": getattr(solver, "_failover_count", 0),
        "device": device_info,
    }


def _child(target_sites: int, screened: bool) -> dict:
    proc = subprocess.run(
        [sys.executable, __file__, "--measure", str(target_sites),
         "screened" if screened else "unscreened"],
        capture_output=True, text=True, timeout=2400,
    )
    sys.stderr.write(proc.stderr[-4000:])
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)
    raise SystemExit(f"measurement child failed (rc={proc.returncode})")


def main():
    # The parent stays off jax: chip_smoke imports nothing heavy at module
    # level.
    from chip_smoke import nvidia_smi_line

    card = nvidia_smi_line()
    unscreened = _child(50_000, screened=False)
    screened = _child(50_000, screened=True)
    print(json.dumps({
        "metric": f"tdgl_steps_per_sec_{unscreened['sites']}site_mesh",
        "value": unscreened["steps_per_sec"],
        "unit": "steps/sec",
        "device": unscreened["device"],
        "card": card,
        "provenance": {"unscreened": unscreened, "screened": screened},
    }), flush=True)


if __name__ == "__main__":
    if len(sys.argv) >= 4 and sys.argv[1] == "--measure":
        print(json.dumps(measure(int(sys.argv[2]),
                                 sys.argv[3] == "screened")), flush=True)
    else:
        main()
