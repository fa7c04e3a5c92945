"""Within-process A/B benchmark for chunk-program variants.

Cross-process comparisons of the 50k benchmark are confounded by
trajectory divergence: f32 rounding chaos means every process's warmup
lands in its own vortex-lattice window, and window hardness moves the
number by up to ~15%. This tool removes
that confound entirely: it warms up ONE solver, then times every
requested chunk-program variant FROM THE SAME post-warmup device state
(immutable arrays -> identical timed trajectory per variant, identical
window hardness across variants), interleaving repetitions A,B,...,A,B
so slow drift (clocks, power) cancels too.

Usage:
    python tools/ab_bench.py --sites 50000 \
        --variants robust_u1,robust_u2,fast_u1,fast_u2,fast_u3

Variant grammar: {robust|fast}_u{N}[_cg{K}][_pred][_i{M}][_site]
[_c{S}] — robust/fast selects StepConfig.fast_chunk, N the scan unroll,
K the fixed mu-CG iteration count (fast program: gated, rewind on
residual failure), pred the extrapolated mu warm start, M (screened)
the inner fixed-iteration count, site the site-evaluated interpolated convolution, S a per-variant
steps-per-chunk override (dispatch-overhead A/B: same timed step count,
different dispatch granularity). Screened variants via --screened
(then fast = single inline screening iteration).

Prints one JSON line per variant: {"variant":..., "steps_per_sec":...}.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import build_device, CHUNK  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sites", type=int, default=50_000)
    ap.add_argument("--variants", type=str,
                    default="robust_u1,robust_u2,fast_u1,fast_u2")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--screened", action="store_true")
    ap.add_argument("--warmup-chunks", type=int, default=2)
    ap.add_argument("--timed-steps", type=int, default=32000)
    args = ap.parse_args()

    import numpy as np

    import tdgl_tpu as tdgl
    from tdgl_tpu.solver.solver import TDGLSolver
    from tdgl_tpu.solver.grid_step import make_grid_chunk_fn
    from tdgl_tpu.utils.jaxio import tree_to_numpy

    device = build_device(args.sites)
    chunk_s = min(CHUNK, 2000) if args.screened else CHUNK
    kwargs = dict(
        solve_time=1e9, dt_init=1e-4, dt_max=1e-2,
        save_every=chunk_s, steps_per_chunk=chunk_s,
        field_units="mT", current_units="uA", dtype="float32",
    )
    if args.screened:
        kwargs.update(include_screening=True, screening_tolerance=1e-3)
    options = tdgl.SolverOptions(**kwargs)
    solver = TDGLSolver(device, options, applied_vector_potential=0.5)
    chunk = solver.chunk_size
    print(f"# sites={len(device.mesh.sites)} chunk={chunk}"
          f" grid={solver.maps.shape}", file=sys.stderr)

    # Build every variant program up front (shared compile cache).
    fns = {}
    for name in args.variants.split(","):
        parts = name.split("_")
        fast = parts[0] == "fast"
        unroll = int(parts[1][1:])
        extra = {}
        v_chunk = chunk
        for p in parts[2:]:
            if p.startswith("cg"):
                extra["poisson_fixed_iters"] = int(p[2:])
            elif p.startswith("tol"):
                extra["poisson_tolerance"] = float(p[3:])
            elif p == "pred":
                extra["poisson_predictor"] = True
            elif p.startswith("i"):
                extra["screening_cg_iters"] = int(p[1:])
            elif p == "site":
                extra["screening_site_eval"] = True
            elif p.startswith("c"):
                v_chunk = int(p[1:])
        ptol = extra.get("poisson_tolerance", solver.cfg.poisson_tolerance)
        cfg = dataclasses.replace(
            solver.cfg, fast_chunk=fast, scan_unroll=unroll,
            poisson_fail_gate=(10.0 * ptol if fast else 0.0),
            **extra,
        )
        fns[name] = (make_grid_chunk_fn(cfg, v_chunk), v_chunk)

    def run(fn, state, n_chunks):
        for _ in range(n_chunks):
            state, outputs, exported = fn(
                solver.sten, solver._screening_weights, solver.amg, state)
        return state, exported

    # Warm up with the ROBUST program (cold-start chunks retry), then pin
    # the shared start state.
    robust = make_grid_chunk_fn(solver.cfg, chunk)
    state = solver._initial_state()
    t0 = time.perf_counter()
    state, exported = run(robust, state, args.warmup_chunks)
    steps0 = int(tree_to_numpy(exported)["diagnostics"][3])
    print(f"# warmup: {steps0} steps in {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)
    state_w = state

    # Per-variant chunk counts sized so every variant times the same
    # number of steps (up to divisibility).
    plan = {
        name: (fn, v_chunk, max(1, args.timed_steps // v_chunk))
        for name, (fn, v_chunk) in fns.items()
    }
    times = {name: [] for name in fns}
    failed = {}
    for rep in range(args.reps):
        for name, (fn, v_chunk, n_chunks) in plan.items():
            if name in failed:
                continue
            steps = n_chunks * v_chunk
            t0 = time.perf_counter()
            try:
                end, exported = run(fn, state_w, n_chunks)
                diag = tree_to_numpy(exported)["diagnostics"]
            except Exception as exc:  # device fault etc.
                failed[name] = str(exc)[:80]
                continue
            dt = time.perf_counter() - t0
            executed = int(diag[3]) - steps0
            if bool(diag[5]):
                failed[name] = "flagged failure during timed window"
                continue
            assert executed == steps, f"{name}: {executed}/{steps} steps"
            times[name].append(dt)
            print(f"# rep {rep} {name}: {dt:.2f}s", file=sys.stderr)

    for name, (fn, v_chunk, n_chunks) in plan.items():
        if name in failed:
            print(json.dumps({"variant": name, "error": failed[name]}))
            continue
        steps = n_chunks * v_chunk
        med = sorted(times[name])[len(times[name]) // 2]
        print(json.dumps({
            "variant": name,
            "steps_per_sec": round(steps / med, 1),
            "reps_s": [round(t, 3) for t in times[name]],
        }))


if __name__ == "__main__":
    main()
