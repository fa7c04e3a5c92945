"""The compiled TDGL time step on the hex-grid stencil backend.

Mirror of :mod:`tdgl_tpu.solver.step` (same semantics, same ``StepConfig``,
same per-step outputs — see that module for the reference call-outs), with
the state held as dense ``(Rp, Cp)`` grid arrays and every operator a
gather-free stencil from :mod:`tdgl_tpu.models.gtdgl_stencil`. The order
parameter is split into real/imaginary arrays (no complex dtype in the
program — see ``gtdgl_stencil`` module docs).

This is the fast path: the stencil step needs no gathers, unlike the ELL
step of ``step.py``, which remains the backend for unstructured meshes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import gtdgl_stencil as gs
from ..ops.cg import solve_mu_poisson_grid
from ..ops.screening import induced_vector_potential
from .step import StepConfig, StepOutputs


class GridState(NamedTuple):
    """Device-resident solver state on the padded grid (a pytree)."""

    psi_r: jax.Array            # (Rp, Cp)
    psi_i: jax.Array            # (Rp, Cp)
    mu: jax.Array               # (Rp, Cp)
    mu_prev: jax.Array          # (Rp, Cp) — previous step's mu (predictor)
    supercurrent: jax.Array     # (3, Rp, Cp)
    normal_current: jax.Array   # (3, Rp, Cp)
    A_induced: jax.Array        # (3, Rp, Cp, 2)
    A_applied: jax.Array        # (3, Rp, Cp, 2)
    epsilon: jax.Array          # (Rp, Cp)
    neumann_term: jax.Array     # (Rp, Cp) — dense Neumann RHS contribution
    dA_dt: jax.Array            # (3, Rp, Cp) — edge-projected dA/dt
    tentative_dt: jax.Array
    prev_dt: jax.Array
    time: jax.Array
    step: jax.Array
    dpsi_window: jax.Array
    end_time: jax.Array
    done: jax.Array
    failed: jax.Array


@jax.jit
def export_grid_diagnostics(state: "GridState") -> jax.Array:
    f = jnp.float32
    return jnp.stack([
        state.time.astype(f),
        state.prev_dt.astype(f),
        state.tentative_dt.astype(f),
        state.step.astype(f),
        state.done.astype(f),
        state.failed.astype(f),
    ])


@jax.jit
def export_grid_state_arrays(state: "GridState"):
    """The grid state as real-typed arrays (host converts to mesh vectors)."""
    return dict(
        psi_real=state.psi_r,
        psi_imag=state.psi_i,
        mu=state.mu,
        supercurrent=state.supercurrent,
        normal_current=state.normal_current,
        induced_vector_potential=state.A_induced,
        applied_vector_potential=state.A_applied,
        epsilon=state.epsilon,
        diagnostics=export_grid_diagnostics(state),
    )


def make_grid_step_fn(cfg: StepConfig):
    """Build ``(sten, screening_weights, amg, state) -> (state, outputs)``.

    ``cfg.probe_ix`` holds *flat padded-grid* indices on this backend.
    Traced time-dependent inputs map t to grid shapes: ``A_fn(t) ->
    (3, Rp, Cp, 2)``, ``eps_fn(t) -> (Rp, Cp)``, ``mu_boundary_fn(t) ->
    (B,)`` (scattered in-program).
    """
    probe_ix = (np.asarray(cfg.probe_ix, dtype=np.int32)
                if cfg.probe_ix else np.zeros((0,), np.int32))

    def euler_psi(sten, U, pr, pi, old_sq, mu, epsilon, dt):
        return gs.implicit_euler_psi(
            sten, U, pr, pi, old_sq, mu, epsilon, cfg.gamma, cfg.u, dt
        )

    def euler_with_retries(sten, rdtype, U, pr, pi, old_sq, mu,
                           epsilon, dt0):
        res0 = euler_psi(sten, U, pr, pi, old_sq, mu, epsilon, dt0)
        if not cfg.adaptive or cfg.fast_chunk:
            return (res0.psi_r, res0.psi_i, res0.abs_sq_psi, dt0,
                    jnp.logical_not(res0.ok))

        def cond(carry):
            dt, r_, i_, sq_, ok, tries = carry
            return jnp.logical_and(jnp.logical_not(ok),
                                   tries <= cfg.max_solve_retries)

        def body(carry):
            dt, r_, i_, sq_, ok, tries = carry
            dt_try = jnp.where(ok, dt, dt * cfg.adaptive_time_step_multiplier)
            res = euler_psi(sten, U, pr, pi, old_sq, mu, epsilon, dt_try)
            keep = lambda old, new: jnp.where(ok, old, new)
            return (dt_try, keep(r_, res.psi_r), keep(i_, res.psi_i),
                    keep(sq_, res.abs_sq_psi), jnp.logical_or(ok, res.ok),
                    tries + 1)

        dt, r_, i_, sq_, ok, _tries = jax.lax.while_loop(
            cond, body,
            (jnp.asarray(dt0, rdtype), res0.psi_r, res0.psi_i,
             res0.abs_sq_psi, res0.ok, np.int32(0)),
        )
        return r_, i_, sq_, dt, jnp.logical_not(ok)

    def observables(sten, amg, U, pr, pi, dA_dt, neumann_term,
                    mu_guess, fixed_iters=None):
        J_s = gs.supercurrent_on_edges(sten, U, pr, pi)
        rhs = gs.poisson_rhs(sten, J_s, dA_dt, neumann_term)
        # The outer (per-step) solve gets a tolerance-stopped top-up after
        # its fixed iterations: a no-op on warm-started steady state, but
        # cold starts / vortex-entry steps can need far more than the fixed
        # count. Inside the screening fixed point (explicit fixed_iters)
        # the solve must stay a smooth map, so no top-up there.
        topup = fixed_iters is None and not cfg.fast_chunk
        if fixed_iters is None:
            fixed_iters = cfg.poisson_fixed_iters
        if cfg.poisson_use_mg:
            from ..ops.cg import mg_richardson_grid

            # Cap the cycle count well below the CG cap: a stalled
            # Richardson iteration (its f32 floor sits above CG's) must
            # fail fast via the residual gate, not spin long enough for
            # the runtime to kill the program. A fixed_iters request (the
            # screening fixed point, or poisson_fixed_iterations) runs a
            # fixed cycle count instead — the smooth, reduction-free map
            # the fixed point needs.
            cg = mg_richardson_grid(
                sten, rhs, mu_guess, amg,
                tol=cfg.poisson_tolerance,
                maxiter=min(50, cfg.poisson_max_iterations),
                amg_omega=cfg.amg_omega,
                fixed_iters=fixed_iters,
                topup=topup,
            )
        else:
            cg = solve_mu_poisson_grid(
                sten, rhs, mu_guess,
                tol=cfg.poisson_tolerance,
                maxiter=cfg.poisson_max_iterations,
                amg=(amg if cfg.use_amg else None),
                amg_omega=cfg.amg_omega,
                fixed_iters=fixed_iters,
                topup=topup,
                sstep=cfg.poisson_sstep,
            )
        J_n = -gs.gradient_on_edges(sten, cg.x) - dA_dt
        return J_s, cg.x, J_n, cg.iterations, cg.residual_norm

    def step(sten, screening_weights, amg, state: GridState,
             static_link=None):
        # The grid backend's screening argument is (weights, fft_data) —
        # fft_data is the precomputed convolution spectrum (or None when
        # screening is off / a pairwise kernel is selected).
        screening_weights, fft_data = screening_weights
        rdtype = state.mu.dtype
        time = state.time
        edge_valid = sten.edge_valid.astype(rdtype)
        if cfg.A_fn is not None:
            A_applied = cfg.A_fn(time).astype(rdtype)
            dirs = sten.edge_dirs.astype(rdtype)
            ndirs = dirs / jnp.linalg.norm(dirs, axis=1, keepdims=True)
            dA = (A_applied - state.A_applied) / state.prev_dt
            dA_dt = (dA[..., 0] * ndirs[:, 0, None, None]
                     + dA[..., 1] * ndirs[:, 1, None, None]) * edge_valid
        else:
            A_applied = state.A_applied
            dA_dt = state.dA_dt
        epsilon = (cfg.eps_fn(time).astype(rdtype)
                   if cfg.eps_fn is not None else state.epsilon)
        if cfg.mu_boundary_fn is not None:
            neumann_term = gs.neumann_boundary_term(
                sten, cfg.mu_boundary_fn(time).astype(rdtype)
            )
        else:
            neumann_term = state.neumann_term

        old_sq = state.psi_r**2 + state.psi_i**2
        dt0 = state.tentative_dt

        def tdgl_update(pr, pi, mu_in, A_induced, dt, fixed_iters=None,
                        solve_guess=None):
            if static_link is not None:
                # Hoisted out of the scan by the chunk driver (static A).
                U = static_link
            else:
                A_total = (A_applied + A_induced if cfg.include_screening
                           else A_applied)
                U = gs.edge_link_phases(sten, A_total)
            pr_n, pi_n, sq_n, dt_used, fail = euler_with_retries(
                sten, rdtype, U, pr, pi, old_sq, mu_in, epsilon, dt
            )
            J_s, mu_n, J_n, cg_iters, cg_res = observables(
                sten, amg, U, pr_n, pi_n, dA_dt, neumann_term,
                mu_in if solve_guess is None else solve_guess,
                fixed_iters=fixed_iters,
            )
            return (pr_n, pi_n, sq_n, mu_n, J_s, J_n, dt_used, fail,
                    cg_iters, cg_res)

        if cfg.include_screening:
            big = np.asarray(1e30, rdtype)
            # Denominator floor for the globally-normalized convergence
            # criterion: during the startup transient the induced potential
            # is orders of magnitude below the applied one, and a purely
            # relative criterion divides iteration noise by ~zero — the
            # fixed point then can never "converge" even though the induced
            # field is dynamically irrelevant. Anything below
            # 1e-2 |A_applied| max contributes negligibly to the link
            # phases, so that's the scale floor.
            app_scale = jnp.max(jnp.linalg.norm(A_applied, axis=-1))

            def s_cond(carry):
                (s, err, *_rest) = carry
                # The chunk driver freezes finished/failed runs with an
                # elementwise select AFTER the step executes, so the step
                # body still runs on stale state. Gating the fixed point on
                # `state.done` keeps those ghost steps O(1): otherwise a
                # failed run spins max_iterations_per_step screening
                # iterations on every remaining step of the chunk (enough
                # device time to trip the runtime's execution kill).
                return jnp.logical_and(
                    jnp.logical_not(state.done),
                    jnp.logical_and(
                        err >= cfg.screening_tolerance,
                        s <= cfg.max_iterations_per_step,
                    ),
                )

            def s_body(carry):
                (s, err, dt, A_ind, velocity, x_prev, pr_n, pi_n, sq_n,
                 mu_n, J_s, J_n, fail, cg_iters, cg_res) = carry
                converged = err < cfg.screening_tolerance
                (pr_u, pi_u, sq_u, mu_u, J_s_u, J_n_u, dt_u, fail_i,
                 cg_iters_u, cg_res_u) = tdgl_update(
                    pr_n, pi_n, mu_n, A_ind, dt,
                    fixed_iters=cfg.screening_cg_iters)
                J_site = gs.edge_quantity_to_sites(sten, J_s_u + J_n_u)
                Jw = J_site * screening_weights[..., None].astype(rdtype)
                if cfg.screening_use_fft:
                    if cfg.screening_eval_fn is not None:
                        A_new = cfg.screening_eval_fn(fft_data, sten, Jw)
                    else:
                        from ..ops import fft_screening as fs

                        if cfg.screening_site_eval:
                            A_new = fs.induced_vector_potential_fft_site(
                                fft_data, sten, Jw,
                                cfg.screening_site_taps,
                            )
                        else:
                            A_new = fs.induced_vector_potential_fft(
                                fft_data, sten, Jw
                            )
                else:
                    far = 1e6 * (1.0 - sten.valid.astype(rdtype))
                    sites_xy = jnp.stack(
                        [sten.site_x.astype(rdtype) + far,
                         sten.site_y.astype(rdtype) + far], axis=-1,
                    ).reshape(-1, 2)
                    ec_xy = jnp.stack(
                        [sten.ec_x.astype(rdtype),
                         sten.ec_y.astype(rdtype)], axis=-1,
                    ).reshape(-1, 2)
                    A_flat = induced_vector_potential(
                        ec_xy, sites_xy, Jw.reshape(-1, 2)
                    )
                    A_new = (A_flat.reshape(A_ind.shape)
                             * edge_valid[..., None])
                dA = A_new - A_ind
                if cfg.screening_anderson:
                    # Depth-1 Anderson (secant) acceleration: the `velocity`
                    # slot carries the previous residual, `x_prev` the
                    # previous iterate. Converges in ~10 iterations where
                    # the fixed-coefficient Polyak scheme contracts at
                    # ~0.99/iteration on strongly-coupled geometries.
                    dr = dA - velocity
                    denom = jnp.maximum(jnp.sum(dr * dr),
                                        jnp.finfo(rdtype).tiny)
                    theta = jnp.clip(jnp.sum(dA * dr) / denom, -10.0, 10.0)
                    anderson = ((1.0 - theta) * A_new
                                + theta * (x_prev + velocity))
                    A_ind_u = jnp.where(
                        s == 0, A_ind + cfg.screening_step_size * dA,
                        anderson,
                    )
                    velocity_u = dA
                    x_prev_u = A_ind
                else:
                    velocity_u = ((1.0 - cfg.screening_step_drag) * velocity
                                  + cfg.screening_step_size * dA)
                    A_ind_u = A_ind + velocity_u
                    x_prev_u = x_prev
                dA_norm = jnp.linalg.norm(dA, axis=-1)
                A_norm = jnp.linalg.norm(A_ind_u, axis=-1)
                if cfg.screening_global_error_norm:
                    denom = jnp.maximum(
                        jnp.max(A_norm),
                        jnp.maximum(0.01 * app_scale, 1e-20),
                    )
                    err_u = jnp.max(dA_norm) / denom
                else:
                    # Per-edge ratio over REAL edges only (masked entries
                    # would contribute 0/1e-20 = 0, which is fine, but the
                    # wrap-around reads are exactly zero too).
                    err_u = jnp.max(dA_norm / jnp.maximum(A_norm, 1e-20))

                def keep(old, new):
                    return jnp.where(converged, old, new)

                return (
                    s + jnp.where(converged, 0, 1),
                    keep(err, err_u),
                    keep(dt, dt_u),
                    keep(A_ind, A_ind_u),
                    keep(velocity, velocity_u),
                    keep(x_prev, x_prev_u),
                    keep(pr_n, pr_u),
                    keep(pi_n, pi_u),
                    keep(sq_n, sq_u),
                    keep(mu_n, mu_u),
                    keep(J_s, J_s_u),
                    keep(J_n, J_n_u),
                    jnp.logical_or(fail, jnp.logical_and(
                        fail_i, jnp.logical_not(converged))),
                    keep(cg_iters, cg_iters_u),
                    keep(cg_res, cg_res_u),
                )

            zeros_e = jnp.zeros_like(state.supercurrent)
            init = (
                np.int32(0), big, dt0, state.A_induced,
                jnp.zeros_like(state.A_induced), state.A_induced,
                state.psi_r, state.psi_i,
                old_sq, state.mu, zeros_e, zeros_e, np.bool_(False),
                np.int32(0), big,
            )
            if cfg.fast_chunk:
                # Steady fast chunk: the Anderson fixed point converges in
                # exactly 1 iteration/step in steady state (measured mean
                # 1.00 at the 50k benchmark), so run ONE inline screening
                # update — no while_loop, no second convolution — and let
                # the error gate below trip chunk failover to the robust
                # program when a step genuinely needs more iterations.
                (s, err, dt_used, A_induced, _vel, _xp, pr_n, pi_n, sq_n,
                 mu_n, J_s, J_n, fail, cg_iters, cg_res) = s_body(init)
            else:
                (s, err, dt_used, A_induced, _vel, _xp, pr_n, pi_n, sq_n,
                 mu_n, J_s, J_n, fail, cg_iters,
                 cg_res) = jax.lax.while_loop(s_cond, s_body, init)
            fail = jnp.logical_or(fail, err >= cfg.screening_tolerance)
            # 2x the CG precision floor: the gate flags gross failure,
            # not precision-edge flutter (tolerance-stopped CG itself clamps
            # at 50 eps, so a healthy solve can sit right at that floor).
            # The fast program gates at poisson_fail_gate with chunk
            # rewind — the same semantics as the unscreened branch (the
            # screening-tolerance gate above still protects the fixed
            # point's own convergence independently).
            mu_gate = (cfg.poisson_fail_gate
                       if cfg.fast_chunk and cfg.poisson_fail_gate > 0
                       else cfg.poisson_tolerance)
            res_allowed = max(mu_gate,
                              100.0 * float(jnp.finfo(rdtype).eps))
            fail = jnp.logical_or(fail, cg_res > res_allowed)
            screening_iters = s
        else:
            guess = (2.0 * state.mu - state.mu_prev
                     if cfg.poisson_predictor else None)
            (pr_n, pi_n, sq_n, mu_n, J_s, J_n, dt_used, fail, cg_iters,
             cg_res) = tdgl_update(
                state.psi_r, state.psi_i, state.mu, state.A_induced, dt0,
                solve_guess=guess,
            )
            if cfg.poisson_fixed_iters is not None or cfg.poisson_use_mg:
                # Fast chunks replace the top-up loop with a (looser,
                # physics-validated) residual gate; a trip triggers the
                # solver's chunk-level failover rather than a RuntimeError.
                gate = (cfg.poisson_fail_gate
                        if cfg.fast_chunk and cfg.poisson_fail_gate > 0
                        else cfg.poisson_tolerance)
                res_allowed = max(gate,
                                  100.0 * float(jnp.finfo(rdtype).eps))
                fail = jnp.logical_or(fail, cg_res > res_allowed)
            A_induced = state.A_induced
            screening_iters = np.int32(0)

        d_psi_sq = jnp.max(jnp.abs(sq_n - old_sq))
        W = cfg.adaptive_window
        window = state.dpsi_window.at[state.step % W].set(
            d_psi_sq.astype(rdtype)
        )
        if cfg.adaptive:
            new_dt_est = cfg.dt_init / jnp.maximum(
                jnp.asarray(1e-10, rdtype), jnp.mean(window)
            )
            tentative = jnp.clip(0.5 * (new_dt_est + dt_used), 0.0,
                                 cfg.dt_max)
            tentative = jnp.where(state.step > W, tentative,
                                  state.tentative_dt)
        else:
            tentative = state.tentative_dt

        new_state = GridState(
            psi_r=pr_n,
            psi_i=pi_n,
            mu=mu_n,
            mu_prev=state.mu,
            supercurrent=J_s,
            normal_current=J_n,
            A_induced=A_induced,
            A_applied=A_applied,
            epsilon=epsilon,
            neumann_term=neumann_term,
            dA_dt=dA_dt,
            tentative_dt=tentative.astype(rdtype),
            prev_dt=jnp.asarray(dt_used, rdtype),
            time=time + dt_used,
            step=state.step + 1,
            dpsi_window=window,
            end_time=state.end_time,
            done=jnp.logical_or(time >= state.end_time, fail),
            failed=jnp.logical_or(state.failed, fail),
        )
        mu_flat = mu_n.reshape(-1)
        outputs = StepOutputs(
            dt=dt_used,
            time=time + dt_used,
            mu_probe=mu_flat[probe_ix],
            theta_probe=jnp.arctan2(pi_n.reshape(-1)[probe_ix],
                                    pr_n.reshape(-1)[probe_ix]),
            screening_iterations=screening_iters,
            cg_iterations=cg_iters,
            valid=np.int32(1),
        )
        return new_state, outputs

    return step


@functools.lru_cache(maxsize=32)
def make_grid_chunk_fn(cfg: StepConfig, chunk_size: int):
    """Jitted ``(sten, screening_weights, amg, state) -> (state, outputs,
    exported)`` advancing up to ``chunk_size`` steps (grid backend).

    Performance structure (each matters at a step time of tens of us):

    * The scan carry holds ONLY what a step actually changes — psi, mu, the
      scalars, and (with screening) the induced potential. Chunk-constant
      fields (A_applied, dA_dt, epsilon, neumann_term) ride as closure
      operands, and the last step's supercurrent/normal current are
      recomputed once after the scan instead of being carried.
    * ``done`` gating is an elementwise select on the small carry, not a
      ``lax.cond``: conditionals materialize both-branch copies of the whole
      carry every iteration.
    * With a static applied potential and no screening, the link variables
      (including their cos/sin) are computed once outside the scan.

    Dynamic inputs still work: with ``cfg.A_fn`` the applied potential and
    ``dA/dt`` are recomputed from ``t`` inside the step (nothing to carry);
    with screening the induced potential joins the carry.
    """
    step_fn = make_grid_step_fn(cfg)
    n_probe = len(cfg.probe_ix) if cfg.probe_ix else 0
    hoist_link = cfg.A_fn is None and not cfg.include_screening
    carry_A_induced = cfg.include_screening

    @jax.jit
    def chunk_fn(sten, screening_weights, amg, state: GridState):
        rdtype = state.mu.dtype
        if not hoist_link:
            static_link = None
        elif cfg.factor_link_phases:
            # Separable static A (solver-verified in f64): the link planes
            # reconstruct in-kernel from four row/col trig vectors — no
            # link-plane HBM reads in the scan at all.
            static_link = gs.factor_link_phases(sten, state.A_applied)
        else:
            static_link = gs.edge_link_phases(sten, state.A_applied)
            if cfg.fold_link_weights:
                static_link = gs.fold_link_phases(sten, static_link,
                                                  bf16=cfg.link_bf16)

        def carry_of(st: GridState):
            c = dict(
                psi_r=st.psi_r, psi_i=st.psi_i, mu=st.mu,
                tentative_dt=st.tentative_dt, prev_dt=st.prev_dt,
                time=st.time, step=st.step, dpsi_window=st.dpsi_window,
                done=st.done, failed=st.failed,
            )
            if cfg.poisson_predictor and not cfg.include_screening:
                c["mu_prev"] = st.mu_prev
            if carry_A_induced:
                c["A_induced"] = st.A_induced
            if cfg.A_fn is not None:
                # dA/dt needs the previous step's applied potential.
                c["A_applied"] = st.A_applied
                c["dA_dt"] = st.dA_dt
            return c

        def state_of(carry) -> GridState:
            return state._replace(
                **{k: v for k, v in carry.items()}
            )

        def scan_body(carry, _):
            # Ghost ("post-done") steps still execute the step body on
            # stale state and get discarded by an elementwise select — NOT
            # a lax.cond: wrapping the step in a conditional breaks XLA's
            # fusion/pipelining across the scan body. Ghost steps are cheap
            # because (a) the screening while_loop's condition tests
            # state.done — the one loop whose ghost iterations could
            # otherwise accumulate real device time — and (b) the
            # warm-started CG on an unchanged stale system converges
            # immediately.
            frozen = carry["done"]
            st = state_of(carry)
            new_st, outputs = step_fn(sten, screening_weights, amg, st,
                                      static_link)
            new_carry = carry_of(new_st)
            new_carry = jax.tree_util.tree_map(
                lambda old, new: jnp.where(frozen, old, new),
                carry, new_carry,
            )
            outputs = outputs._replace(
                valid=jnp.where(frozen, np.int32(0), np.int32(1)),
                dt=jnp.where(frozen, np.zeros((), rdtype), outputs.dt),
            )
            return new_carry, outputs

        # Scan unrolling lets XLA interleave independent work of adjacent
        # steps (reductions vs elementwise); >1 trades compile time for
        # pipelining (cfg.scan_unroll; TDGL_SCAN_UNROLL overrides for
        # experiments).
        import os

        unroll = int(os.environ.get("TDGL_SCAN_UNROLL", "0")) \
            or cfg.scan_unroll
        final_carry, outputs = jax.lax.scan(scan_body, carry_of(state),
                                            xs=None, length=chunk_size,
                                            unroll=unroll)
        final = state_of(final_carry)
        # Chunk-constant fields dropped from the carry must be refreshed at
        # the final time when they are traced functions of t.
        if cfg.eps_fn is not None:
            final = final._replace(
                epsilon=cfg.eps_fn(final.time).astype(rdtype)
            )
        if cfg.mu_boundary_fn is not None:
            final = final._replace(neumann_term=gs.neumann_boundary_term(
                sten, cfg.mu_boundary_fn(final.time).astype(rdtype)
            ))
        # Recompute the last step's currents once (they are pure functions
        # of the final psi/mu — cheaper than carrying them through the scan).
        if static_link is not None:
            U = static_link
        else:
            A_total = (final.A_applied + final.A_induced
                       if cfg.include_screening else final.A_applied)
            U = gs.edge_link_phases(sten, A_total)
        J_s = gs.supercurrent_on_edges(sten, U, final.psi_r, final.psi_i)
        J_n = -gs.gradient_on_edges(sten, final.mu) - final.dA_dt
        # Only update the currents when the chunk actually advanced
        # (otherwise keep the seed state's values bit-for-bit).
        advanced = final.step > state.step
        final = final._replace(
            supercurrent=jnp.where(advanced, J_s, state.supercurrent),
            normal_current=jnp.where(advanced, J_n, state.normal_current),
        )
        return final, outputs, export_grid_state_arrays(final)

    return chunk_fn
