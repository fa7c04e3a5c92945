"""Traced-ramp transport throughput (the IV-curve workload).

A ~50k-site current-biased bridge with a jittable bias ramp
(``@tdgl.jittable``): the ramp is evaluated INSIDE the compiled step via
the baked (boundary-edge x terminal) Neumann matrix, so the solver keeps
its full fused chunk size. Host-path callables — the reference's
semantics, one Python evaluation per step
(``tdgl/solver/solver.py:325-345`` in the reference) — cap at one step
per host dispatch.

Throughput on the GPU: not measured yet.

Usage: python tools/ramp_bench.py [--sites 50000] [--chunks 4]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sites", type=int, default=50_000)
    ap.add_argument("--chunk", type=int, default=8000)
    ap.add_argument("--chunks", type=int, default=4)
    args = ap.parse_args()

    import jax.numpy as jnp
    import numpy as np

    import tdgl_tpu as tdgl
    from tdgl_tpu.geometry import box
    from tdgl_tpu.solver.solver import TDGLSolver
    from tdgl_tpu.utils.jaxio import tree_to_numpy

    xi = 1.0
    layer = tdgl.Layer(coherence_length=xi, london_lambda=2, thickness=0.1,
                       conductivity=10.0)
    area = args.sites * 0.238
    W = float(np.sqrt(area * 150.0 / 80.0))
    H = area / W
    film = tdgl.Polygon("film", points=box(W, H)).resample(1000)
    source = tdgl.Polygon(points=box(2.0, H, center=(-W / 2, 0))
                          ).set_name("source")
    drain = source.copy().scale(xfact=-1).set_name("drain")
    device = tdgl.Device("bridge", layer=layer, film=film,
                         terminals=[source, drain], length_units="um")
    device.make_mesh(min_points=args.sites, max_edge_length=0.75,
                     structured=True)
    print("# sites:", len(device.mesh.sites), flush=True)

    @tdgl.jittable
    def ramp(t):
        bias = 2000.0 * jnp.minimum(t / 200.0, 1.0)   # uA: ramp, then hold
        return dict(source=bias, drain=-bias)

    options = tdgl.SolverOptions(
        solve_time=1e9, dt_init=1e-4, dt_max=1e-2, save_every=args.chunk,
        steps_per_chunk=args.chunk, field_units="mT", current_units="uA",
        dtype="float32")
    solver = TDGLSolver(device, options, terminal_currents=ramp)
    assert solver.chunk_size == args.chunk, "traced path did not engage"
    assert not solver.host_dynamic
    state = solver._initial_state()
    t0 = time.perf_counter()
    for _ in range(2):
        state, outputs, exported = solver.chunk_fn(state)
    d0 = tree_to_numpy(exported)["diagnostics"]
    print(f"# compiled+warm in {time.perf_counter() - t0:.0f}s;"
          f" t={d0[0]:.1f}", flush=True)
    assert not bool(d0[5]), "solver failed in warmup"
    t0 = time.perf_counter()
    for _ in range(args.chunks):
        state, outputs, exported = solver.chunk_fn(state)
    d1 = tree_to_numpy(exported)["diagnostics"]
    elapsed = time.perf_counter() - t0
    steps = int(d1[3] - d0[3])
    assert steps == args.chunks * args.chunk
    assert not bool(d1[5]), "solver failed"
    print(f"# traced-ramp transport: {steps} steps in {elapsed:.2f}s ="
          f" {steps / elapsed:.0f} steps/s (t={d1[0]:.1f})", flush=True)


if __name__ == "__main__":
    main()
