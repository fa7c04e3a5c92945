"""The compiled TDGL time step and chunked scan driver.

One TDGL step — implicit-Euler psi update with discriminant-retry, the
supercurrent, the CG mu-Poisson solve, the normal current, the optional
screening fixed point, and the adaptive-dt selection — is a single pure
function ``state -> (state, outputs)``, with every data-dependent loop
expressed as ``lax.while_loop`` so the whole thing lives inside one XLA
program. ``steps_per_chunk`` steps are then fused with ``lax.scan`` between
host synchronizations.

Semantics follow the reference update loop (``tdgl/solver/solver.py:580-714``
and ``tdgl/solver/runner.py:330-454``), including:

* the tentative time step is chosen once per step and only reduced by
  discriminant retries (``solver.py:441-487``);
* the adaptive dt estimate averages ``max |d|psi|^2|`` over the last
  ``adaptive_window`` steps (``background.rst: dt-tentative``);
* one extra step executes after ``time >= end_time`` (the reference's runner
  breaks *after* the update);
* the screening loop is a Polyak fixed point re-running the full
  psi/mu/current update each iteration (``solver.py:654-688``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import gtdgl
from ..ops.cg import solve_mu_poisson
from ..ops.screening import induced_vector_potential


class SolverState(NamedTuple):
    """The full device-resident solver state (a pytree)."""

    psi: jax.Array              # (N, 2) re/im pair (split complex; see
                                # models/gtdgl.py)
    mu: jax.Array               # (N,)
    mu_prev: jax.Array          # (N,) — previous step's mu (solve predictor)
    supercurrent: jax.Array     # (E,)
    normal_current: jax.Array   # (E,)
    A_induced: jax.Array        # (E, 2)
    A_applied: jax.Array        # (E, 2) — current applied vector potential
    epsilon: jax.Array          # (N,)
    mu_boundary: jax.Array      # (B,) current-density BC per boundary edge
    dA_dt: jax.Array            # (E,) edge-projected dA/dt (host-set when the
                                # applied potential is dynamic but not traced)
    tentative_dt: jax.Array     # scalar
    prev_dt: jax.Array          # scalar — dt used in the previous step
    time: jax.Array             # scalar
    step: jax.Array             # scalar int32 — step index within the stage
    dpsi_window: jax.Array      # (W,) ring buffer of max |d|psi|^2|
    end_time: jax.Array         # scalar — stage end time
    done: jax.Array             # scalar bool
    failed: jax.Array           # scalar bool (retry/screening non-convergence)


class StepOutputs(NamedTuple):
    """Per-step scalars recorded by the runner (cf. RunningState).

    ``valid`` is int32 (1/0) rather than bool: some constrained backends
    cannot transfer boolean buffers to the host.
    """

    dt: jax.Array
    time: jax.Array
    mu_probe: jax.Array         # (P,)
    theta_probe: jax.Array      # (P,)
    screening_iterations: jax.Array
    cg_iterations: jax.Array
    valid: jax.Array            # int32 — 0 for frozen (post-done) slots


@jax.jit
def export_diagnostics(state: "SolverState") -> jax.Array:
    """Scalar state fields as one float32 vector (transferable everywhere).

    Returns ``[time, prev_dt, tentative_dt, step, done, failed]`` stacked on
    a leading axis of length 6 (trailing batch axes preserved under vmap).
    """
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
def export_state_arrays(state: "SolverState"):
    """The full state as real-typed arrays (psi split into re/im).

    One compiled program transferring only >=1-d real buffers — the robust
    path for host snapshots on backends that cannot fetch complex/bool/0-d
    buffers.
    """
    return dict(
        psi_real=state.psi[..., 0],
        psi_imag=state.psi[..., 1],
        mu=state.mu,
        supercurrent=state.supercurrent,
        normal_current=state.normal_current,
        induced_vector_potential=state.A_induced,
        applied_vector_potential=state.A_applied,
        epsilon=state.epsilon,
        diagnostics=export_diagnostics(state),
    )


@dataclass(frozen=True)
class StepConfig:
    """Static configuration compiled into the step function."""

    gamma: float
    u: float
    adaptive: bool
    dt_init: float
    dt_max: float
    adaptive_window: int
    max_solve_retries: int
    adaptive_time_step_multiplier: float
    include_screening: bool
    screening_tolerance: float
    screening_step_size: float
    screening_step_drag: float
    max_iterations_per_step: int
    poisson_tolerance: float
    poisson_max_iterations: int
    probe_ix: Optional[tuple] = None          # tuple of site indices
    # Jax-traceable time-dependent inputs (fast path). Each maps a scalar
    # time to the full array; None means the corresponding state field is
    # used as-is (static, or host-updated between chunks).
    A_fn: Optional[Callable] = None           # t -> (E, 2)
    eps_fn: Optional[Callable] = None         # t -> (N,)
    mu_boundary_fn: Optional[Callable] = None  # t -> (B,)
    # Two-level AMG preconditioner for the mu solve (None -> Jacobi). The
    # device arrays travel as a traced argument; only the static flag and
    # smoothing weight live here.
    use_amg: bool = False
    # Scalar damping, or a tuple of per-sweep dampings (Chebyshev pairs);
    # see ops.hexmg.make_hexmg_apply.
    amg_omega: object = 0.9
    # Globally-normalized screening error (f32 path; see SolverOptions
    # ``screening_error_norm``) instead of the reference's per-edge ratio.
    screening_global_error_norm: bool = False
    # Exact FFT-convolution induced-A kernel (structured backend only).
    screening_use_fft: bool = False
    # Evaluate the screening convolution at the lattice SITES with a
    # single moment-matched kernel and interpolate to the 3 edge classes
    # (ops.fft_screening.induced_vector_potential_*_site): ~half the
    # arithmetic and 1/3 the intermediates of the exact per-edge-class
    # convolution, for an O(h^2) discretization difference of the same
    # order as the f32 screening floor. See
    # SolverOptions.screening_site_eval.
    screening_site_eval: bool = False
    # Static per-class near-field correction stencils for the site path
    # (ops.fft_screening.build_site_interp_taps): a hashable tuple of
    # ((dr, dc), value) taps per edge class, baked into the compiled
    # chunk (roll offsets must be trace-time constants). None when the
    # mesh margins make the tap rolls wrap-unsafe — site evaluation is
    # then unavailable.
    screening_site_taps: Optional[tuple] = None
    # CG iterations per mu solve inside the screening fixed point (fixed
    # count -> smooth map; see ``observables``).
    screening_cg_iters: int = 32
    # Fixed CG iteration count for every mu solve (None = tolerance-stopped).
    poisson_fixed_iters: Optional[int] = None
    # Stencil backend: fixed multigrid-Richardson cycles instead of CG.
    poisson_use_mg: bool = False
    # Compute the fixed 2-iteration phase of the mu solve as one blocked
    # 2D Krylov step (ops.cg.cg_solve_2step_topup): exact-arithmetic-same
    # as 2 PCG iterations with 3 fewer reduction sync points.
    poisson_sstep: bool = False
    # Anderson(1) acceleration for the screening fixed point (False =
    # reference-style Polyak heavy ball).
    screening_anderson: bool = True
    # Warm-start the mu solve from the linear extrapolation
    # ``2 mu_n - mu_{n-1}`` instead of ``mu_n`` (see
    # SolverOptions.poisson_warm_start). Pure solver-guess change: with
    # tolerance-stopped CG the solution is unchanged; with fixed-iteration
    # solves it lands ~4x closer (measured).
    poisson_predictor: bool = False
    # Override for the FFT screening evaluation: a callable
    # ``(fft_data, sten, J_weighted) -> (3, Rp, Cp, 2)`` replacing
    # ops.fft_screening.induced_vector_potential_fft. Used by
    # parallel/fft_sharded.py to run the convolution as per-device pencil
    # FFTs under spatial sharding (hashed by identity for the chunk
    # cache, like A_fn).
    screening_eval_fn: Optional[Callable] = None
    # Stencil backend, static-A fast path: premultiply the FV weights into
    # the hoisted link phases (models.gtdgl_stencil.FoldedLinkPhases) so
    # the covariant Laplacian reads 6 planes/step instead of 15 (the
    # negative-edge planes are derived as rolls of the positive-edge
    # products — exact) — plane reads ARE the cost (HBM-bound). Same math
    # up to f32 rounding order.
    fold_link_weights: bool = False
    # Stencil backend, static separable-A fast path: reconstruct the link
    # planes in-kernel from factored row/col trig vectors
    # (models.gtdgl_stencil.FactoredLinkPhases) — no link-plane HBM reads
    # at all. Enabled by the solver only after a float64 separability
    # check of the applied potential; supersedes fold_link_weights.
    factor_link_phases: bool = False
    # Store the folded link tables in bfloat16 (halves their read
    # bandwidth; ~4e-3 relative perturbation of the link phases — f32
    # accumulation via mixed-precision promotion). Physics-gated.
    link_bf16: bool = False
    # lax.scan unroll factor for the chunk loop. >1 lets XLA interleave
    # independent work of adjacent steps (the step's serial reductions
    # overlap the next step's elementwise planes) at higher compile cost.
    # Pure scheduling — the per-step math is unchanged.
    scan_unroll: int = 1
    # Stencil backend "steady fast chunk": strip the per-step retry and
    # top-up while_loops from the compiled chunk entirely (single psi
    # attempt, fixed-count mu solve) and FLAG any step whose psi solve
    # rejects or whose mu residual exceeds ``poisson_fail_gate`` instead
    # of repairing it in-program. The solver pairs this program with
    # chunk-level failover: on a flag, the host rewinds to the chunk-start
    # state (chunk inputs are not donated) and re-runs the chunk with the
    # robust while_loop program, so the accepted trajectory never contains
    # a flagged step. Motivation: the two loop barriers cost step time
    # even on windows where they never fire.
    fast_chunk: bool = False
    # Residual gate for fast-chunk steps (same norm as poisson_tolerance).
    # Steps landing in (poisson_tolerance, poisson_fail_gate] are accepted
    # without top-up — the band sits inside the physics-validated
    # mu-tolerance envelope (docs/validation.md measured no observable
    # drift up to 1e-3) — anything above triggers chunk failover. 0.0
    # means "use the robust gate" (only meaningful with fast_chunk).
    poisson_fail_gate: float = 0.0


def make_step_fn(cfg: StepConfig):
    """Build the single-step function
    ``(op, screening_weights, amg, state) -> (state, outputs)``.

    ``op`` (the FV operator tables) and ``screening_weights`` (per-site
    screening prefactor ``A_scale * xi * area``, or a dummy array when
    screening is off) are traced arguments, NOT closed-over constants — this
    keeps multi-megabyte mesh tables out of the compiled program text and
    avoids device->host fetches during lowering.
    """
    probe_ix = (np.asarray(cfg.probe_ix, dtype=np.int32)
                if cfg.probe_ix else np.zeros((0,), np.int32))

    def euler_with_retries(op, rdtype, U, psi, old_sq, mu, epsilon, dt0):
        """Adaptive Euler update with dt-shrinking retries
        (``solver.py:441-487``)."""
        res0 = gtdgl.implicit_euler_psi(
            op, U, psi, old_sq, mu, epsilon, cfg.gamma, cfg.u, dt0
        )
        if not cfg.adaptive:
            return res0.psi, res0.abs_sq_psi, dt0, jnp.logical_not(res0.ok)

        def cond(carry):
            dt, psi_n, sq_n, ok, tries = carry
            return jnp.logical_and(jnp.logical_not(ok),
                                   tries <= cfg.max_solve_retries)

        def body(carry):
            # Gate every update on `ok` so the loop is vmap-safe: under vmap,
            # while_loop applies the body to already-converged batch members.
            dt, psi_n, sq_n, ok, tries = carry
            dt_try = jnp.where(ok, dt, dt * cfg.adaptive_time_step_multiplier)
            res = gtdgl.implicit_euler_psi(
                op, U, psi, old_sq, mu, epsilon, cfg.gamma, cfg.u, dt_try
            )
            psi_out = jnp.where(ok, psi_n, res.psi)
            sq_out = jnp.where(ok, sq_n, res.abs_sq_psi)
            return (dt_try, psi_out, sq_out, jnp.logical_or(ok, res.ok),
                    tries + 1)

        dt, psi_n, sq_n, ok, tries = jax.lax.while_loop(
            cond, body,
            (jnp.asarray(dt0, rdtype), res0.psi, res0.abs_sq_psi, res0.ok,
             np.int32(0)),
        )
        return psi_n, sq_n, dt, jnp.logical_not(ok)

    def observables(op, amg, U, psi, dA_dt, mu_boundary, mu_guess,
                    fixed_iters=None):
        """Supercurrent, mu (CG), and normal current (``solver.py:489-520``).

        ``fixed_iters`` (used inside the screening fixed point) runs CG for a
        fixed iteration count — a smooth map, unlike tolerance-stopped CG
        whose discontinuities block screening convergence below the CG
        tolerance. Returns the CG residual as a 5th element for failure
        detection.
        """
        J_s = gtdgl.supercurrent_on_edges(op, U, psi)
        rhs = gtdgl.poisson_rhs(op, J_s, dA_dt, mu_boundary)
        # Outer solve: fixed iterations + tolerance-stopped top-up (no-op
        # in steady state, rescues cold starts). Screening's inner solves
        # (explicit fixed_iters) must stay smooth: no top-up.
        topup = fixed_iters is None
        if fixed_iters is None:
            fixed_iters = cfg.poisson_fixed_iters
        cg = solve_mu_poisson(
            op, rhs, mu_guess,
            tol=cfg.poisson_tolerance, maxiter=cfg.poisson_max_iterations,
            amg=(amg if cfg.use_amg else None), amg_omega=cfg.amg_omega,
            fixed_iters=fixed_iters, topup=topup,
        )
        J_n = -gtdgl.gradient_on_edges(op, cg.x) - dA_dt
        return J_s, cg.x, J_n, cg.iterations, cg.residual_norm

    def step(op, screening_weights, amg, state: SolverState):
        n_sites = op.areas.shape[0]
        rdtype = state.mu.dtype
        time = state.time
        # --- time-dependent inputs (fast, traced path) ---
        if cfg.A_fn is not None:
            A_applied = cfg.A_fn(time).astype(rdtype)
            norm_dir = (op.edge_directions
                        / jnp.linalg.norm(op.edge_directions, axis=1,
                                          keepdims=True)).astype(rdtype)
            dA_dt = jnp.sum(
                (A_applied - state.A_applied) / state.prev_dt * norm_dir,
                axis=1,
            )
        else:
            A_applied = state.A_applied
            dA_dt = state.dA_dt
        epsilon = (cfg.eps_fn(time).astype(rdtype)
                   if cfg.eps_fn is not None else state.epsilon)
        mu_boundary = (cfg.mu_boundary_fn(time).astype(rdtype)
                       if cfg.mu_boundary_fn is not None
                       else state.mu_boundary)

        old_sq = jnp.sum(state.psi * state.psi, axis=-1)
        dt0 = state.tentative_dt

        def tdgl_update(psi_in, mu_in, A_induced, dt, fixed_iters=None,
                        solve_guess=None):
            # Within the screening fixed point the reference feeds the
            # previous iteration's psi and mu back into the Euler update
            # while keeping |psi^n|^2 as the old superfluid density
            # (``solver.py:649,676-680``). ``solve_guess`` only changes the
            # mu-solve warm start (the physics input stays ``mu_in``).
            A_total = (A_applied + A_induced if cfg.include_screening
                       else A_applied)
            U = gtdgl.edge_link_phases(A_total, op.edge_directions)
            psi_n, sq_n, dt_used, fail = euler_with_retries(
                op, rdtype, U, psi_in, old_sq, mu_in, epsilon, dt
            )
            J_s, mu_n, J_n, cg_iters, cg_res = observables(
                op, amg, U, psi_n, dA_dt, mu_boundary,
                mu_in if solve_guess is None else solve_guess,
                fixed_iters=fixed_iters,
            )
            return (psi_n, sq_n, mu_n, J_s, J_n, dt_used, fail, cg_iters,
                    cg_res)

        if cfg.include_screening:
            big = np.asarray(1e30, rdtype)
            # Startup-transient floor for the global error norm (see
            # grid_step: a tiny induced potential makes any purely relative
            # criterion divide noise by ~zero).
            app_norm_dirs = jnp.linalg.norm(A_applied, axis=-1)
            app_scale = jnp.max(app_norm_dirs)

            def s_cond(carry):
                (s, err, *_rest) = carry
                return jnp.logical_and(
                    err >= cfg.screening_tolerance,
                    s <= cfg.max_iterations_per_step,
                )

            def s_body(carry):
                (s, err, dt, A_ind, velocity, x_prev, psi_n, sq_n, mu_n,
                 J_s, J_n, fail, cg_iters, cg_res) = carry
                # Gate on convergence for vmap-safety (see euler retries).
                converged = err < cfg.screening_tolerance
                (psi_u, sq_u, mu_u, J_s_u, J_n_u, dt_u, fail_i,
                 cg_iters_u, cg_res_u) = tdgl_update(
                    psi_n, mu_n, A_ind, dt,
                    fixed_iters=cfg.screening_cg_iters)
                J_site = gtdgl.edge_quantity_to_sites(op, J_s_u + J_n_u,
                                                      n_sites)
                Jw = J_site * screening_weights[:, None].astype(rdtype)
                A_new = induced_vector_potential(
                    op.edge_centers.astype(rdtype),
                    op.sites.astype(rdtype), Jw,
                )
                dA = A_new - A_ind
                if cfg.screening_anderson:
                    # Depth-1 Anderson acceleration (see grid_step).
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
                dA_norm = jnp.linalg.norm(dA, axis=1)
                A_norm = jnp.linalg.norm(A_ind_u, axis=1)
                if cfg.screening_global_error_norm:
                    # f32 path: max |dA| / max |A|. The reference's per-edge
                    # ratio (below) floors at ~2e-5 in float32 because edges
                    # with |A_e| ~ 1e-4 max|A| amplify summation noise.
                    denom = jnp.maximum(
                        jnp.max(A_norm),
                        jnp.maximum(0.01 * app_scale, 1e-20),
                    )
                    err_u = jnp.max(dA_norm) / denom
                else:
                    # Reference semantics (``solver.py:570-575``).
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
                    keep(psi_n, psi_u),
                    keep(sq_n, sq_u),
                    keep(mu_n, mu_u),
                    keep(J_s, J_s_u),
                    keep(J_n, J_n_u),
                    jnp.logical_or(fail, jnp.logical_and(
                        fail_i, jnp.logical_not(converged))),
                    keep(cg_iters, cg_iters_u),
                    keep(cg_res, cg_res_u),
                )

            zeros_e = jnp.zeros(op.edges.shape[0], rdtype)
            init = (
                np.int32(0), big, dt0, state.A_induced,
                jnp.zeros_like(state.A_induced), state.A_induced,
                state.psi, old_sq, state.mu,
                zeros_e, zeros_e, np.bool_(False), np.int32(0), big,
            )
            (s, err, dt_used, A_induced, _vel, _xp, psi_n, sq_n, mu_n, J_s,
             J_n, fail, cg_iters, cg_res) = jax.lax.while_loop(s_cond,
                                                               s_body, init)
            fail = jnp.logical_or(fail, err >= cfg.screening_tolerance)
            # The fixed-iteration CG solves have no internal stopping test;
            # verify the final solve actually met the (precision-floored)
            # Poisson tolerance.
            # 2x the CG precision floor: the gate flags gross failure,
            # not precision-edge flutter (tolerance-stopped CG itself clamps
            # at 50 eps, so a healthy solve can sit right at that floor).
            res_allowed = max(cfg.poisson_tolerance,
                              100.0 * float(jnp.finfo(rdtype).eps))
            fail = jnp.logical_or(fail, cg_res > res_allowed)
            screening_iters = s
        else:
            guess = (2.0 * state.mu - state.mu_prev
                     if cfg.poisson_predictor else None)
            (psi_n, sq_n, mu_n, J_s, J_n, dt_used, fail, cg_iters,
             cg_res) = tdgl_update(
                state.psi, state.mu, state.A_induced, dt0,
                solve_guess=guess,
            )
            if cfg.poisson_fixed_iters is not None:
                # Fixed-iteration CG has no internal stopping test; verify
                # the (precision-floored) tolerance was met.
                res_allowed = max(cfg.poisson_tolerance,
                                  100.0 * float(jnp.finfo(rdtype).eps))
                fail = jnp.logical_or(fail, cg_res > res_allowed)
            A_induced = state.A_induced
            screening_iters = np.int32(0)

        # --- adaptive time-step selection (``solver.py:698-707``) ---
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

        new_state = SolverState(
            psi=psi_n,
            mu=mu_n,
            mu_prev=state.mu,
            supercurrent=J_s,
            normal_current=J_n,
            A_induced=A_induced,
            A_applied=A_applied,
            epsilon=epsilon,
            mu_boundary=mu_boundary,
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
        outputs = StepOutputs(
            dt=dt_used,
            time=time + dt_used,
            mu_probe=mu_n[probe_ix],
            theta_probe=jnp.arctan2(psi_n[probe_ix, 1], psi_n[probe_ix, 0]),
            screening_iterations=screening_iters,
            cg_iterations=cg_iters,
            valid=np.int32(1),
        )
        return new_state, outputs

    return step


@functools.lru_cache(maxsize=32)
def make_chunk_fn(cfg: StepConfig, chunk_size: int):
    """Build a jitted function ``(op, screening_weights, amg, state) ->
    (state, outputs, exported)`` advancing up to ``chunk_size`` steps.

    Steps after ``done`` pass the state through unchanged and emit
    ``valid=0`` outputs, so shapes stay static while the host controls stage
    boundaries.

    ``exported`` is the real-typed host view of the final state
    (``export_state_arrays``), computed INSIDE the same compiled program:
    constrained backends that cannot compile small auxiliary programs or
    transfer complex/bool/0-d buffers only ever see one large program with
    >=1-d real outputs.
    """
    step_fn = make_step_fn(cfg)
    n_probe = len(cfg.probe_ix) if cfg.probe_ix else 0

    @jax.jit
    def chunk_fn(op, screening_weights, amg, state: SolverState):
        rdtype = state.mu.dtype

        def zero_outputs():
            z = np.zeros((), rdtype)
            return StepOutputs(
                dt=z, time=z,
                mu_probe=np.zeros(n_probe, rdtype),
                theta_probe=np.zeros(n_probe, rdtype),
                screening_iterations=np.int32(0),
                cg_iterations=np.int32(0),
                valid=np.int32(0),
            )

        def scan_body(state, _):
            return jax.lax.cond(
                state.done,
                lambda st: (st, zero_outputs()),
                lambda st: step_fn(op, screening_weights, amg, st),
                state,
            )

        new_state, outputs = jax.lax.scan(scan_body, state, xs=None,
                                          length=chunk_size)
        return new_state, outputs, export_state_arrays(new_state)

    return chunk_fn
