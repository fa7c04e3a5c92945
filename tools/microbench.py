"""Per-component microbenchmark / fault-bisect harness for the TDGL step.

Times individual pieces of the compiled step (psi update, CG matvec, full CG
solve, full step, scan overhead) on the current jax backend, with the
fetch-forced, execution-proven timing discipline bench.py uses. Each variant
runs in its own subprocess when orchestrated via ``--all``, one after
another, so a fault in one cannot affect the following measurements.

Usage:
    python tools/microbench.py --all --sites 50000       # orchestrate
    python tools/microbench.py --variant step --sites 25000 --iters 2000

Each child prints one JSON line:
    {"variant": ..., "sites": N, "edges": E, "iters": K,
     "total_s": T, "us_per_iter": U, "ok": true}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = (
    "noop",          # scan carry passthrough — scan/dispatch overhead
    "axpy",          # one vector axpy per iteration — minimal kernel chain
    "psi_lap",       # covariant Laplacian only
    "psi_update",    # full implicit-Euler psi update (no retry loop)
    "cg_matvec",     # one symmetric-Laplacian matvec + axpy (no dots)
    "cg_iter",       # one true PCG iteration (matvec + 2 dots + axpys)
    "mu_solve",      # full warm-started CG solve per iteration
    "step",          # the production step function
    "chunk",         # the production chunked scan (chunk=500)
)


def build_problem(target_sites: int):
    import tdgl_tpu as tdgl
    from tdgl_tpu.solver.solver import TDGLSolver

    import numpy as np

    layer = tdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                       thickness=0.1, conductivity=10.0)
    from tdgl_tpu.geometry import box

    side = float(np.sqrt(target_sites * 0.238))
    film = tdgl.Polygon("film", points=box(side)).resample(
        max(200, int(11 * side))
    )
    device = tdgl.Device("bench", layer=layer, film=film, length_units="um")
    device.make_mesh(min_points=target_sites, max_edge_length=0.75, smooth=10)
    options = tdgl.SolverOptions(
        solve_time=1e9, dt_init=1e-4, dt_max=1e-2, save_every=500,
        field_units="mT", current_units="uA", dtype="float32",
    )
    solver = TDGLSolver(device, options, applied_vector_potential=0.5)
    return solver


def timed_scan(fn, init_carry, iters: int, fetch):
    """Jit a ``lax.scan`` of ``fn`` (carry -> carry) with an execution-proof
    counter; returns (elapsed_seconds, final_carry_host_fetch)."""
    import jax
    import jax.numpy as jnp

    def body(carry, _):
        state, count = carry
        return (fn(state), count + 1), None

    @jax.jit
    def run(carry):
        carry, _ = jax.lax.scan(body, carry, xs=None, length=iters)
        return carry

    # Warmup (compile + one execution), then fetch to prove completion. The
    # counter is part of the carry so it accumulates across run() calls.
    carry = run((init_carry, jnp.int32(0)))
    c0 = fetch(carry[0], carry[1])
    t0 = time.perf_counter()
    carry = run(carry)
    c1 = fetch(carry[0], carry[1])
    elapsed = time.perf_counter() - t0
    assert c1[1] - c0[1] == iters, f"executed {c1[1] - c0[1]} != {iters}"
    return elapsed


def run_variant(variant: str, target_sites: int, iters: int,
                cpu: bool = False) -> dict:
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from tdgl_tpu.models import gtdgl
    from tdgl_tpu.ops.cg import cg_solve, solve_mu_poisson
    from tdgl_tpu.utils.jaxio import to_numpy

    solver = build_problem(target_sites)
    op = solver.op
    cfg = solver.cfg
    state = solver._initial_state()
    n_sites = len(solver.mesh.sites)
    n_edges = solver.num_edges
    rdtype = np.float32

    A = state.A_applied
    U = gtdgl.edge_link_phases(A, op.edge_directions)
    psi = state.psi  # (N, 2) split-complex pair
    sq = jnp.sum(psi * psi, axis=-1)
    mu = state.mu
    eps = state.epsilon
    dt = np.float32(cfg.dt_init)

    def fetch_scalar(state_arr, count):
        arr = to_numpy(state_arr if state_arr.ndim else state_arr[None])
        return float(np.sum(arr[:1])), int(to_numpy(count[None])[0])

    if variant == "noop":
        def fn(x):
            return x
        init = jnp.zeros(n_sites, rdtype)
        def fetch(s, c):
            return fetch_scalar(s, c)
    elif variant == "axpy":
        def fn(x):
            return x + 1e-9 * x
        init = jnp.ones(n_sites, rdtype)
        fetch = fetch_scalar
    elif variant == "psi_lap":
        def fn(p):
            lap = gtdgl.covariant_laplacian(op, U, p)
            return p + np.float32(1e-9) * lap
        init = psi

        def fetch(s, c):
            return fetch_scalar(s.real, c)
    elif variant == "psi_update":
        def fn(p):
            res = gtdgl.implicit_euler_psi(op, U, p, jnp.sum(p * p, axis=-1), mu,
                                           eps, cfg.gamma, cfg.u, dt)
            return res.psi
        init = psi

        def fetch(s, c):
            return fetch_scalar(s.real, c)
    elif variant == "cg_matvec":
        def fn(x):
            y = gtdgl.scalar_laplacian_sym(op, x)
            return x + np.float32(1e-9) * y
        init = mu + 1.0
        fetch = fetch_scalar
    elif variant == "cg_iter":
        # One PCG iteration worth of work: matvec + 2 dots + 3 axpys,
        # with the dots feeding scalars back into the vector ops.
        inv_diag = 1.0 / jnp.maximum(op.w_sym_rowsum, 1e-30)

        def fn(carry):
            x, p = carry
            Ap = -gtdgl.scalar_laplacian_sym(op, p)
            alpha = jnp.sum(p * p) / jnp.maximum(jnp.sum(p * Ap), 1e-30)
            x = x + alpha * p
            z = inv_diag * Ap
            beta = jnp.sum(Ap * z) / jnp.maximum(jnp.sum(p * p), 1e-30)
            p = z + 1e-9 * beta * p
            return (x, p)
        init = (mu, mu + 1.0)

        def fetch(s, c):
            return fetch_scalar(s[0], c)
    elif variant == "mu_solve":
        J_s = gtdgl.supercurrent_on_edges(op, U, psi)
        rhs = gtdgl.poisson_rhs(op, J_s, state.dA_dt, state.mu_boundary)

        def fn(m):
            res = solve_mu_poisson(
                op, rhs + np.float32(1e-9) * m[:1], m,
                tol=cfg.poisson_tolerance,
                maxiter=cfg.poisson_max_iterations,
                amg=(solver.amg if cfg.use_amg else None),
            )
            return res.x
        init = mu
        fetch = fetch_scalar
    elif variant == "step":
        from tdgl_tpu.solver.step import make_step_fn

        step_fn = make_step_fn(cfg)

        def fn(st):
            new_st, _ = step_fn(op, solver._screening_weights, solver.amg,
                                st)
            return new_st
        init = state

        def fetch(s, c):
            return fetch_scalar(s.mu, c)
    elif variant == "chunk":
        chunk_fn = solver.chunk_fn
        t0 = time.perf_counter()
        st, _, exported = chunk_fn(state)
        from tdgl_tpu.utils.jaxio import tree_to_numpy

        d0 = tree_to_numpy(exported)["diagnostics"]
        compile_s = time.perf_counter() - t0
        n_chunks = max(1, iters // solver.chunk_size)
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            st, _, exported = chunk_fn(st)
        d1 = tree_to_numpy(exported)["diagnostics"]
        elapsed = time.perf_counter() - t0
        steps = int(d1[3] - d0[3])
        assert steps == n_chunks * solver.chunk_size
        return dict(variant=variant, sites=n_sites, edges=n_edges,
                    iters=steps, total_s=round(elapsed, 4),
                    us_per_iter=round(1e6 * elapsed / steps, 2),
                    compile_s=round(compile_s, 1), ok=True)
    else:
        raise ValueError(variant)

    elapsed = timed_scan(fn, init, iters, fetch)
    return dict(variant=variant, sites=n_sites, edges=n_edges, iters=iters,
                total_s=round(elapsed, 4),
                us_per_iter=round(1e6 * elapsed / iters, 2), ok=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", choices=VARIANTS)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--sites", type=int, default=25_000)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--timeout", type=int, default=600)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (in-process config)")
    args = ap.parse_args()

    if args.all:
        import subprocess

        for variant in VARIANTS:
            try:
                cmd = [sys.executable, __file__, "--variant", variant,
                       "--sites", str(args.sites), "--iters",
                       str(args.iters)]
                if args.cpu:
                    cmd.append("--cpu")
                proc = subprocess.run(
                    cmd, capture_output=True, text=True,
                    timeout=args.timeout,
                )
                out = [ln for ln in proc.stdout.splitlines()
                       if ln.startswith("{")]
                if proc.returncode == 0 and out:
                    print(out[-1], flush=True)
                else:
                    err = (proc.stderr or "")[-300:].replace("\n", " | ")
                    print(json.dumps(dict(variant=variant, ok=False,
                                          rc=proc.returncode, err=err)),
                          flush=True)
            except subprocess.TimeoutExpired:
                print(json.dumps(dict(variant=variant, ok=False,
                                      err="timeout")), flush=True)
        return

    if not args.variant:
        ap.error("--variant or --all required")
    result = run_variant(args.variant, args.sites, args.iters,
                         cpu=args.cpu)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
