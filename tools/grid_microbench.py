"""Grid-backend (stencil) component microbenchmarks on the current backend.

Times the mu-solve building blocks and screening kernels at the 50k-site
benchmark scale with the fetch-forced, execution-proven discipline from
bench.py: each variant is a jitted ``lax.scan`` of K iterations whose carry
includes a counter, timed between two host fetches.

Usage:
    python tools/grid_microbench.py [--sites 50000] [--iters 200]
        [--variants vcycle,stencil,...]

Prints one JSON line per variant.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = ("noop", "reduce", "stencil", "vcycle", "cg2", "cg3", "mgr2",
            "mgr3", "sstep2", "fft_screen", "psi_update", "psi_folded",
            "psi_factored", "rhs_xla", "rhs_factored")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sites", type=int, default=50_000)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--variants", type=str, default=",".join(VARIANTS))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--unroll", type=int, default=1,
                    help="lax.scan unroll factor for the timed loop "
                         "(amortizes the per-scan-iteration runtime floor)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    import tdgl_tpu as tdgl
    from tdgl_tpu.geometry import box
    from tdgl_tpu.models import gtdgl_stencil as gs
    from tdgl_tpu.ops.cg import cg_solve_fixed, mg_richardson_grid
    from tdgl_tpu.ops.hexmg import make_hexmg_apply
    from tdgl_tpu.solver.solver import TDGLSolver
    from tdgl_tpu.utils.jaxio import to_numpy

    layer = tdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                       thickness=0.1, conductivity=10.0)
    side = float(np.sqrt(args.sites * 0.238))
    film = tdgl.Polygon("film", points=box(side)).resample(
        max(200, int(11 * side)))
    device = tdgl.Device("bench", layer=layer, film=film, length_units="um")
    device.make_mesh(min_points=args.sites, max_edge_length=0.75,
                     structured=True)
    options = tdgl.SolverOptions(
        solve_time=1e9, dt_init=1e-4, dt_max=1e-2, save_every=500,
        steps_per_chunk=500, field_units="mT", current_units="uA",
        dtype="float32", include_screening=False,
    )
    solver = TDGLSolver(device, options, applied_vector_potential=0.5)
    sten = solver.sten
    amg = solver.amg
    maps = solver.maps
    state = solver._initial_state()
    print(f"# grid {maps.shape}, backend={jax.default_backend()}",
          file=sys.stderr)
    rd = jnp.float32
    rng = np.random.default_rng(0)
    r0 = jnp.asarray(
        rng.normal(size=maps.shape).astype(np.float32)
        * np.asarray(solver.host_sten.valid))
    apply_mg = make_hexmg_apply(0.9)
    valid = sten.valid.astype(rd)
    n_valid = jnp.sum(valid)

    def project(v):
        return (v - jnp.sum(v * valid) / n_valid) * valid

    def apply_A(x):
        return -gs.scalar_laplacian_sym(sten, x)

    U0 = gs.edge_link_phases(sten, state.A_applied)

    def timed(name, fn, init, iters):
        """fn: carry -> carry (arrays only)."""
        def body(carry, _):
            x, c = carry
            return (fn(x), c + 1), None

        @jax.jit
        def run(carry):
            return jax.lax.scan(body, carry, xs=None, length=iters,
                                unroll=args.unroll)[0]

        t0 = time.perf_counter()
        carry = run((init, jnp.int32(0)))
        first = jax.tree_util.tree_leaves(carry[0])[0]
        c0 = int(to_numpy(carry[1][None])[0])
        _ = float(np.sum(to_numpy(first.reshape(-1)[:8])))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        carry = run(carry)
        first = jax.tree_util.tree_leaves(carry[0])[0]
        _ = float(np.sum(to_numpy(first.reshape(-1)[:8])))
        c1 = int(to_numpy(carry[1][None])[0])
        elapsed = time.perf_counter() - t0
        assert c1 - c0 == iters, f"{name}: executed {c1 - c0} != {iters}"
        print(json.dumps(dict(
            variant=name, iters=iters,
            us_per_iter=round(1e6 * elapsed / iters, 2),
            compile_s=round(compile_s, 1),
        )), flush=True)

    chosen = args.variants.split(",")
    eps = jnp.asarray(1e-9, rd)

    if "noop" in chosen:
        # Scan-iteration floor: one elementwise op per iteration.
        timed("noop", lambda x: x + eps, r0, args.iters)
    if "reduce" in chosen:
        # One full-plane reduction consumed by a broadcast back into the
        # carry — the sync-point pattern of CG dots / loop conditions.
        timed("reduce", lambda x: x + eps * jnp.max(jnp.abs(x)), r0,
              args.iters)
    if "stencil" in chosen:
        timed("stencil", lambda x: x + eps * apply_A(x), r0, args.iters)
    if "vcycle" in chosen:
        timed("vcycle", lambda x: x + eps * apply_mg(amg, x), r0,
              args.iters)
    if "psi_update" in chosen:
        def psi_fn(carry):
            pr, pi = carry
            res = gs.implicit_euler_psi(
                sten, U0, pr, pi, pr * pr + pi * pi, r0, state.epsilon,
                solver.cfg.gamma, solver.cfg.u, jnp.asarray(1e-4, rd))
            return (res.psi_r, res.psi_i)
        timed("psi_update", psi_fn, (state.psi_r, state.psi_i), args.iters)

    if "psi_folded" in chosen or "psi_factored" in chosen:
        def make_psi_fn(U):
            def fn(carry):
                pr, pi = carry
                res = gs.implicit_euler_psi(
                    sten, U, pr, pi, pr * pr + pi * pi, r0, state.epsilon,
                    solver.cfg.gamma, solver.cfg.u, jnp.asarray(1e-4, rd))
                return (res.psi_r, res.psi_i)
            return fn

        if "psi_folded" in chosen:
            Uf = gs.fold_link_phases(sten, U0)
            timed("psi_folded", make_psi_fn(Uf),
                  (state.psi_r, state.psi_i), args.iters)
        if "psi_factored" in chosen:
            # state.A_applied carries the smooth full-grid fill (the
            # solver auto-enables the factored path on this workload).
            Ux = gs.factor_link_phases(sten, state.A_applied)
            timed("psi_factored", make_psi_fn(Ux),
                  (state.psi_r, state.psi_i), args.iters)
    if "rhs_factored" in chosen:
        Ux2 = gs.factor_link_phases(sten, state.A_applied)

        def rhs_factored_fn(x):
            J_s = gs.supercurrent_on_edges(sten, Ux2, x, state.psi_i)
            rhs = gs.poisson_rhs(sten, J_s, state.dA_dt,
                                 state.neumann_term)
            return x + eps * rhs
        timed("rhs_factored", rhs_factored_fn, state.psi_r, args.iters)
    if "rhs_xla" in chosen:
        def rhs_xla_fn(x):
            J_s = gs.supercurrent_on_edges(sten, U0, x, state.psi_i)
            rhs = gs.poisson_rhs(sten, J_s, state.dA_dt,
                                 state.neumann_term)
            return x + eps * rhs
        timed("rhs_xla", rhs_xla_fn, state.psi_r, args.iters)
    rhs0 = gs.poisson_rhs(
        sten, gs.supercurrent_on_edges(sten, U0, state.psi_r, state.psi_i),
        state.dA_dt, state.neumann_term)

    def solve_variant(kind, k):
        if kind == "cg":
            def fn(m):
                out = cg_solve_fixed(
                    apply_A, project(-(sten.area.astype(rd) * rhs0))
                    + eps * m[:1, :1], m, k,
                    precond=lambda r: apply_mg(amg, r), project_fn=project)
                return out.x
        else:
            def fn(m):
                out = mg_richardson_grid(
                    sten, rhs0 + eps * m[:1, :1], m, amg, fixed_iters=k)
                return out.x
        return fn

    if "sstep2" in chosen:
        from tdgl_tpu.ops.cg import cg_solve_2step_topup

        def sstep_fn(m):
            out = cg_solve_2step_topup(
                apply_A, project(-(sten.area.astype(rd) * rhs0))
                + eps * m[:1, :1], m, tol=1e-4,
                precond=lambda r: apply_mg(amg, r), project_fn=project)
            return out.x
        timed("sstep2", sstep_fn, state.mu, args.iters)
    if "cg2" in chosen:
        timed("cg2", solve_variant("cg", 2), state.mu, args.iters)
    if "cg3" in chosen:
        timed("cg3", solve_variant("cg", 3), state.mu, args.iters)
    if "mgr2" in chosen:
        timed("mgr2", solve_variant("mgr", 2), state.mu, args.iters)
    if "mgr3" in chosen:
        timed("mgr3", solve_variant("mgr", 3), state.mu, args.iters)

    if "fft_screen" in chosen:
        from tdgl_tpu.ops.fft_screening import (
            build_fft_screening,
            induced_vector_potential_fft,
        )

        fftd = build_fft_screening(solver.host_sten, maps,
                                   device.mesh.grid)
        Jw0 = jnp.stack([r0, -r0], axis=-1)

        def f_fn(Jw):
            A = induced_vector_potential_fft(fftd, sten, Jw)
            return Jw + eps * A[0]
        timed("fft_screen", f_fn, Jw0, max(20, args.iters // 5))


if __name__ == "__main__":
    main()
