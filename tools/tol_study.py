"""Does relaxing the f32 mu-Poisson tolerance change the physics?

Round 3 validated the f32 auto-default 3e-5 by showing psi/mu errors vs a
float64 reference are identical for tolerances 3e-6 / 1e-5 / 3e-5 (float32
input rounding dominates both).  This study extends the ladder UP (1e-4,
3e-4, 1e-3) to find where the solve tolerance starts to matter, because
every factor ~20 of tolerance is one MG-CG iteration in the hot loop.

Two workloads, both fixed-dt (adaptive dt selection is chaotic and would
swamp the comparison with trajectory divergence):

* transport: a current-biased bridge (mu scale ~ bias) — mu drives the
  observable (voltage), so mu-solve error feeds the physics directly.
* vortex: the bench film at 0.5 mT — psi dynamics with live vortices over
  a short horizon (before f32 rounding chaos decorrelates trajectories).

For each tolerance, errors are measured against the float64
tight-tolerance run of the SAME workload.  Prints one JSON line per
(workload, dtype, tol).

Usage: python tools/tol_study.py [--sites 8000] [--steps 400]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_transport(sites):
    import numpy as np

    import tdgl_tpu as tdgl
    from tdgl_tpu.geometry import box

    layer = tdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                       thickness=0.1, conductivity=10.0)
    side = float(np.sqrt(sites * 0.238))
    film = tdgl.Polygon("film", points=box(1.5 * side, side / 1.5))
    source = tdgl.Polygon(points=box(0.1 * side, side / 1.5,
                                     center=(-0.75 * side, 0))).set_name(
        "source")
    drain = source.copy().scale(xfact=-1).set_name("drain")
    device = tdgl.Device("bridge", layer=layer, film=film,
                         terminals=[source, drain],
                         probe_points=[(-0.5 * side, 0), (0.5 * side, 0)])
    device.make_mesh(min_points=sites, max_edge_length=0.75,
                     structured=True)
    return device, dict(terminal_currents=dict(source=30.0, drain=-30.0))


def build_vortex(sites):
    import numpy as np

    import tdgl_tpu as tdgl
    from tdgl_tpu.geometry import box

    layer = tdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                       thickness=0.1, conductivity=10.0)
    side = float(np.sqrt(sites * 0.238))
    film = tdgl.Polygon("film", points=box(side)).resample(
        max(200, int(11 * side)))
    device = tdgl.Device("film", layer=layer, film=film, length_units="um")
    device.make_mesh(min_points=sites, max_edge_length=0.75,
                     structured=True)
    return device, dict(applied_vector_potential=0.5)


def run(device, solver_kwargs, *, dtype, tol, steps, chunk, dt,
        fixed1=False):
    import jax

    import tdgl_tpu as tdgl
    from tdgl_tpu.solver.solver import TDGLSolver
    from tdgl_tpu.utils.jaxio import to_numpy

    extra = {}
    if fixed1:
        # The gated fixed-1 fast program: ONE MG-CG iteration per step,
        # committed iff the residual holds the 10x-tolerance fail gate
        # (1e-2 at tol=1e-3); gate trips rewind the chunk to the robust
        # (fixed+top-up) program: the unscreened fast program's own
        # configuration.
        extra.update(poisson_fixed_iterations=1, chunk_failover="auto")
    options = tdgl.SolverOptions(
        solve_time=1e9, dt_init=dt, adaptive=False,
        save_every=chunk, steps_per_chunk=chunk,
        field_units="mT", current_units="uA", dtype=dtype,
        poisson_tolerance=tol, **extra,
    )
    solver = TDGLSolver(device, options, **solver_kwargs)
    state = solver._initial_state()
    for _ in range(steps // chunk):
        state, outputs, _ = solver.chunk_fn(state)
    jax.block_until_ready(state.mu)
    assert not bool(to_numpy(state.failed)), "run failed"
    return (to_numpy(state.psi_r), to_numpy(state.psi_i),
            to_numpy(state.mu), solver)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sites", type=int, default=8000)
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    chunk = 100
    dt = 1e-3

    for workload, builder in (("transport", build_transport),
                              ("vortex", build_vortex)):
        device, kwargs = builder(args.sites)
        ref_psi_r, ref_psi_i, ref_mu, _ = run(
            device, kwargs, dtype="float64", tol=1e-12,
            steps=args.steps, chunk=chunk, dt=dt)
        psi_scale = max(float(np.abs(ref_psi_r).max()),
                        float(np.abs(ref_psi_i).max()), 1e-30)
        mu_scale = max(float(np.abs(ref_mu).max()), 1e-30)
        for tol in (3e-6, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2):
            pr, pi, mu, solver = run(
                device, kwargs, dtype="float32", tol=tol,
                steps=args.steps, chunk=chunk, dt=dt)
            row = dict(
                workload=workload,
                tol=tol,
                psi_err=float(max(np.abs(pr - ref_psi_r).max(),
                                  np.abs(pi - ref_psi_i).max())) / psi_scale,
                mu_err=float(np.abs(mu - ref_mu).max()) / mu_scale,
                mu_scale=mu_scale,
            )
            print(json.dumps(row), flush=True)
        # The gated fixed-1 fast program at tol=1e-3 (fail gate 1e-2):
        # the round-5 throughput candidate. Committed-step residuals are
        # bounded by the gate, so together with the tolerance-stopped
        # 3e-3/1e-2 rows above this brackets its physics.
        pr, pi, mu, solver = run(
            device, kwargs, dtype="float32", tol=1e-3,
            steps=args.steps, chunk=chunk, dt=dt, fixed1=True)
        row = dict(
            workload=workload,
            tol="fixed1_gate1e-2",
            failovers=getattr(solver, "_failover_count", None),
            psi_err=float(max(np.abs(pr - ref_psi_r).max(),
                              np.abs(pi - ref_psi_i).max())) / psi_scale,
            mu_err=float(np.abs(mu - ref_mu).max()) / mu_scale,
            mu_scale=mu_scale,
        )
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
