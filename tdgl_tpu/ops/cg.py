"""Device-resident linear solvers for the mu-Poisson equation.

The reference caches a sparse LU factorization of the (fixed) mu-Laplacian
and back-substitutes every step (``tdgl/finite_volume/operators.py:296-308``,
``tdgl/solver/solver.py:504-518``). Sparse triangular solves are inherently
sequential and map poorly onto an accelerator, so we solve the Poisson problem
iteratively instead:

* **Deflated, Jacobi-preconditioned conjugate gradients** on the symmetric
  form ``S mu = diag(a) rhs`` (``S`` = area-unscaled Neumann FV Laplacian,
  symmetric negative semidefinite with null space = constants).
* Warm-started from the previous step's ``mu`` — under small dt the potential
  changes slowly, so CG typically needs only a handful of iterations.
* Fully traced: a ``lax.while_loop`` with static shapes, fusable into the
  same XLA program as the rest of the TDGL step.

The null-space (constant) component is projected out of the residual, which
pins the arbitrary additive constant of ``mu``; only potential *differences*
are physical.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class CGResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array  # scalar int
    residual_norm: jax.Array  # scalar: final ||r|| / ||b||


def _project_out_constant(v: jax.Array) -> jax.Array:
    return v - jnp.mean(v)


def cg_solve(
    apply_A: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array,
    precond_inv_diag: Optional[jax.Array] = None,
    tol: float = 1e-7,
    maxiter: int = 500,
    deflate_constant: bool = True,
    precond: Optional[Callable[[jax.Array], jax.Array]] = None,
    project_fn: Optional[Callable[[jax.Array], jax.Array]] = None,
) -> CGResult:
    """Preconditioned conjugate gradients with optional constant-mode deflation.

    Args:
        apply_A: SPD (or SPsD with constant null space) operator.
        b: Right-hand side.
        x0: Warm-start guess.
        precond_inv_diag: Inverse-diagonal (Jacobi) preconditioner values.
        tol: Relative residual tolerance ||r|| <= tol * ||b||.
        maxiter: Iteration cap (static).
        deflate_constant: Project the constant mode out of b, x, and r
            (required for the pure-Neumann Poisson operator).
        project_fn: Custom deflation projector (e.g. a masked mean on padded
            grids); overrides ``deflate_constant``.
    """
    rdtype = b.dtype

    if project_fn is not None:
        project = project_fn
    else:
        def project(v):
            return _project_out_constant(v) if deflate_constant else v

    b = project(b)
    x0 = project(x0)
    b_norm_sq = jnp.maximum(jnp.sum(b * b), jnp.finfo(rdtype).tiny)
    # Don't chase tolerances below what the working precision can deliver.
    eps = float(jnp.finfo(rdtype).eps)
    tol_eff = max(float(tol), 50.0 * eps)
    # np (host) constant: an eager jnp scalar would embed a 0-d device
    # constant, which some backends cannot fetch during lowering.
    tol_sq = np.asarray(tol_eff, rdtype) ** 2 * b_norm_sq

    def M_inv(v):
        # No deflation projection of z: with r kept deflated, any constant
        # component of z is invisible to rz (constants are orthogonal to the
        # projected r), contributes nothing through A p, and only shifts x
        # by a constant — which the final projection removes. Skipping it
        # saves a reduction per iteration.
        if precond is not None:
            return precond(v)
        if precond_inv_diag is None:
            return v
        return precond_inv_diag.astype(rdtype) * v

    r0 = project(b - apply_A(x0))
    z0 = M_inv(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)

    def cond(state):
        _, r, _, _, _, k, ok = state
        return jnp.logical_and(
            ok, jnp.logical_and(jnp.sum(r * r) > tol_sq, k < maxiter)
        )

    def body(state):
        x, r, z, p, rz, k, ok = state
        Ap = apply_A(p)
        pAp = jnp.sum(p * Ap)
        # Breakdown detection: in finite precision the curvature p^T A p can
        # collapse to <= 0 once the residual stagnates; stepping with a
        # clamped denominator would blow up x. Freeze instead.
        healthy = jnp.logical_and(jnp.isfinite(pAp),
                                  pAp > jnp.finfo(rdtype).tiny)
        alpha = jnp.where(healthy, rz / jnp.where(healthy, pAp, 1.0), 0.0)
        x_new = x + alpha * p
        r_new = project(r - alpha * Ap)
        z_new = M_inv(r_new)
        rz_new = jnp.sum(r_new * z_new)
        beta = jnp.where(
            healthy, rz_new / jnp.where(jnp.abs(rz) > 0, rz, 1.0), 0.0
        )
        p_new = z_new + beta * p

        def keep(old, new):
            return jnp.where(healthy, new, old)

        return (keep(x, x_new), keep(r, r_new), keep(z, z_new),
                keep(p, p_new), keep(rz, rz_new), k + 1,
                jnp.logical_and(ok, healthy))

    x, r, _, _, _, k, _ok = jax.lax.while_loop(
        cond, body,
        (x0, r0, z0, p0, rz0, np.int32(0), np.bool_(True)),
    )
    res = jnp.sqrt(jnp.sum(r * r) / b_norm_sq)
    return CGResult(project(x), k, res)


def cg_solve_fixed(
    apply_A: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array,
    n_iters: int,
    precond_inv_diag: Optional[jax.Array] = None,
    deflate_constant: bool = True,
    precond: Optional[Callable[[jax.Array], jax.Array]] = None,
    project_fn: Optional[Callable[[jax.Array], jax.Array]] = None,
) -> CGResult:
    """Fixed-iteration preconditioned CG (``lax.fori_loop``, no stopping test).

    Unlike :func:`cg_solve`, this runs exactly ``n_iters`` iterations with no
    convergence branch, so

    * XLA can pipeline the loop body (no scalar-reduction-gated ``while``),
      and
    * the solve is a **smooth** function of its inputs — adaptive stopping
      makes the map discontinuous at the tolerance scale, which blocks the
      screening fixed point from converging below the CG tolerance in
      float32.

    Guards against breakdown (pAp <= 0) by freezing the step, like
    :func:`cg_solve`, but without early exit.
    """
    rdtype = b.dtype

    if project_fn is not None:
        project = project_fn
    else:
        def project(v):
            return _project_out_constant(v) if deflate_constant else v

    b = project(b)
    x0 = project(x0)

    def M_inv(v):
        # See cg_solve: z needs no deflation projection while r stays
        # deflated.
        if precond is not None:
            return precond(v)
        if precond_inv_diag is None:
            return v
        return precond_inv_diag.astype(rdtype) * v

    r0 = project(b - apply_A(x0))
    z0 = M_inv(r0)
    rz0 = jnp.sum(r0 * z0)

    def body(_, state):
        x, r, z, p, rz = state
        Ap = apply_A(p)
        pAp = jnp.sum(p * Ap)
        healthy = jnp.logical_and(jnp.isfinite(pAp),
                                  pAp > jnp.finfo(rdtype).tiny)
        alpha = jnp.where(healthy, rz / jnp.where(healthy, pAp, 1.0), 0.0)
        x_new = x + alpha * p
        r_new = project(r - alpha * Ap)
        z_new = M_inv(r_new)
        rz_new = jnp.sum(r_new * z_new)
        beta = jnp.where(
            healthy, rz_new / jnp.where(jnp.abs(rz) > 0, rz, 1.0), 0.0
        )
        p_new = z_new + beta * p

        def keep(old, new):
            return jnp.where(healthy, new, old)

        return (keep(x, x_new), keep(r, r_new), keep(z, z_new),
                keep(p, p_new), keep(rz, rz_new))

    x, r, _, _, _ = jax.lax.fori_loop(
        0, n_iters, body, (x0, r0, z0, z0, rz0)
    )
    b_norm_sq = jnp.maximum(jnp.sum(b * b), jnp.finfo(rdtype).tiny)
    res = jnp.sqrt(jnp.sum(r * r) / b_norm_sq)
    return CGResult(project(x), jnp.int32(n_iters), res)


def cg_solve_topup(
    apply_A: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array,
    base_iters: int,
    tol: float = 1e-6,
    maxiter: int = 200,
    precond: Optional[Callable[[jax.Array], jax.Array]] = None,
    precond_inv_diag: Optional[jax.Array] = None,
    deflate_constant: bool = True,
    project_fn: Optional[Callable[[jax.Array], jax.Array]] = None,
) -> CGResult:
    """Fixed-count CG with a tolerance-stopped top-up.

    Runs exactly ``base_iters`` pipelined iterations (``lax.fori_loop``, no
    convergence branch — the fast path), then keeps iterating in a
    ``lax.while_loop`` while the residual still exceeds ``tol``. In steady
    state (warm-started solves during live dynamics) the top-up never
    fires and its only cost is the loop condition's residual reduction;
    on hard systems (cold starts, vortex entry at large dt) it restores
    the tolerance-stopped robustness that a bare fixed count lacks.
    """
    rdtype = b.dtype

    if project_fn is not None:
        project = project_fn
    else:
        def project(v):
            return _project_out_constant(v) if deflate_constant else v

    b = project(b)
    x0 = project(x0)
    b_norm_sq = jnp.maximum(jnp.sum(b * b), jnp.finfo(rdtype).tiny)
    eps = float(jnp.finfo(rdtype).eps)
    tol_eff = max(float(tol), 50.0 * eps)
    tol_sq = np.asarray(tol_eff, rdtype) ** 2 * b_norm_sq

    def M_inv(v):
        if precond is not None:
            return precond(v)
        if precond_inv_diag is None:
            return v
        return precond_inv_diag.astype(rdtype) * v

    r0 = project(b - apply_A(x0))
    z0 = M_inv(r0)
    rz0 = jnp.sum(r0 * z0)

    def iteration(state, reproject=True):
        x, r, z, p, rz = state
        Ap = apply_A(p)
        pAp = jnp.sum(p * Ap)
        healthy = jnp.logical_and(jnp.isfinite(pAp),
                                  pAp > jnp.finfo(rdtype).tiny)
        alpha = jnp.where(healthy, rz / jnp.where(healthy, pAp, 1.0), 0.0)
        x_new = x + alpha * p
        # Null-space deflation of r is exact-arithmetic-stable across
        # iterations (A annihilates constants and its range is orthogonal
        # to them), so for the short fixed phase the per-iteration
        # re-projection — one full-array reduction — is skipped; drift is
        # O(eps) per iteration and the final projection removes it. The
        # (rare, long) top-up phase keeps the re-projection.
        r_new = r - alpha * Ap
        if reproject:
            r_new = project(r_new)
        z_new = M_inv(r_new)
        rz_new = jnp.sum(r_new * z_new)
        beta = jnp.where(
            healthy, rz_new / jnp.where(jnp.abs(rz) > 0, rz, 1.0), 0.0
        )
        p_new = z_new + beta * p

        def keep(old, new):
            return jnp.where(healthy, new, old)

        return (keep(x, x_new), keep(r, r_new), keep(z, z_new),
                keep(p, p_new), keep(rz, rz_new), healthy)

    def fbody(_, state):
        return iteration(state, reproject=False)[:5]

    x, r, z, p, rz = jax.lax.fori_loop(
        0, base_iters, fbody, (x0, r0, z0, z0, rz0)
    )

    def cond(state):
        x, r, z, p, rz, k, ok = state
        return jnp.logical_and(
            ok, jnp.logical_and(jnp.sum(r * r) > tol_sq, k < maxiter)
        )

    def body(state):
        x, r, z, p, rz, k, ok = state
        x, r, z, p, rz, healthy = iteration((x, r, z, p, rz))
        return (x, r, z, p, rz, k + 1, jnp.logical_and(ok, healthy))

    x, r, _, _, _, k, _ok = jax.lax.while_loop(
        cond, body, (x, r, z, p, rz, np.int32(base_iters), np.bool_(True))
    )
    res = jnp.sqrt(jnp.sum(r * r) / b_norm_sq)
    return CGResult(project(x), k, res)


def cg_solve_2step_topup(
    apply_A: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array,
    tol: float = 1e-6,
    maxiter: int = 200,
    precond: Optional[Callable[[jax.Array], jax.Array]] = None,
    project_fn: Optional[Callable[[jax.Array], jax.Array]] = None,
) -> CGResult:
    """TWO preconditioned-CG iterations computed as one blocked 2D Krylov
    minimization (s-step CG with s = 2), plus the tolerance-stopped
    top-up of :func:`cg_solve_topup`.

    Exact-arithmetic-equivalent to 2 PCG iterations: the PCG iterate
    ``x_2`` minimizes the A-norm error over ``x0 + span{M r0, M A M r0}``,
    which is solved here directly via the 2x2 Gram system. Why bother:
    sequential CG's scalars (alpha, beta) each gate the next vector op —
    4 reduction -> scalar -> broadcast round trips per 2 iterations, each
    a device-wide synchronization. The blocked form computes the SAME basis with
    2 applies + 2 V-cycles and then all 5 Gram/rhs dot products as one
    *independent* reduction batch, removing 3 of the 4 sync points from
    the hot path.

    Breakdown guards: near-singular Gram (linearly dependent basis —
    happens when the warm start is already converged) falls back to the
    steepest 1D step, then to x0.
    """
    rdtype = b.dtype

    if project_fn is not None:
        project = project_fn
    else:
        project = _project_out_constant

    def M_inv(v):
        return precond(v) if precond is not None else v

    b = project(b)
    x0 = project(x0)
    b_norm_sq = jnp.maximum(jnp.sum(b * b), jnp.finfo(rdtype).tiny)
    eps = float(jnp.finfo(rdtype).eps)
    tol_eff = max(float(tol), 50.0 * eps)
    tol_sq = np.asarray(tol_eff, rdtype) ** 2 * b_norm_sq

    r0 = project(b - apply_A(x0))
    v1 = M_inv(r0)
    Av1 = apply_A(v1)
    v2 = M_inv(project(Av1))
    Av2 = apply_A(v2)
    # All five scalars are mutually independent: one reduction batch.
    g11 = jnp.sum(v1 * Av1)
    g12 = jnp.sum(v1 * Av2)
    g22 = jnp.sum(v2 * Av2)
    c1 = jnp.sum(v1 * r0)
    c2 = jnp.sum(v2 * r0)
    det = g11 * g22 - g12 * g12
    tiny = jnp.finfo(rdtype).tiny
    safe2 = jnp.abs(det) > 1e3 * tiny * jnp.maximum(g11 * g22, tiny)
    safe1 = g11 > tiny
    a2 = (c1 * g22 - c2 * g12) / jnp.where(safe2, det, 1.0)
    b2 = (g11 * c2 - g12 * c1) / jnp.where(safe2, det, 1.0)
    a1 = c1 / jnp.where(safe1, g11, 1.0)
    alpha = jnp.where(safe2, a2, jnp.where(safe1, a1, 0.0))
    beta = jnp.where(safe2, b2, 0.0)
    x = x0 + alpha * v1 + beta * v2
    r = project(r0 - alpha * Av1 - beta * Av2)

    # Tolerance-stopped top-up (restarted PCG from (x, r); no-op in
    # steady state — its only cost is the loop condition's reduction).
    z = M_inv(r)
    rz = jnp.sum(r * z)

    def cond(state):
        x, r, z, p, rz, k, ok = state
        return jnp.logical_and(
            ok, jnp.logical_and(jnp.sum(r * r) > tol_sq, k < maxiter)
        )

    def body(state):
        x, r, z, p, rz, k, ok = state
        Ap = apply_A(p)
        pAp = jnp.sum(p * Ap)
        healthy = jnp.logical_and(jnp.isfinite(pAp), pAp > tiny)
        al = jnp.where(healthy, rz / jnp.where(healthy, pAp, 1.0), 0.0)
        x_new = x + al * p
        r_new = project(r - al * Ap)
        z_new = M_inv(r_new)
        rz_new = jnp.sum(r_new * z_new)
        be = jnp.where(healthy,
                       rz_new / jnp.where(jnp.abs(rz) > 0, rz, 1.0), 0.0)
        p_new = z_new + be * p

        def keep(old, new):
            return jnp.where(healthy, new, old)

        return (keep(x, x_new), keep(r, r_new), keep(z, z_new),
                keep(p, p_new), keep(rz, rz_new), k + 1,
                jnp.logical_and(ok, healthy))

    x, r, _, _, _, k, _ok = jax.lax.while_loop(
        cond, body, (x, r, z, z, rz, np.int32(2), np.bool_(True))
    )
    res = jnp.sqrt(jnp.sum(r * r) / b_norm_sq)
    return CGResult(project(x), k, res)


def mg_richardson_grid(
    sten,
    rhs: jax.Array,
    mu_prev: jax.Array,
    amg,
    tol: float = 1e-6,
    maxiter: int = 50,
    amg_omega: float = 0.9,
    fixed_iters: Optional[int] = None,
    topup: bool = False,
) -> CGResult:
    """Multigrid-Richardson mu solve (stencil backend).

    ``x_{k+1} = x_k + M(b - A x_k)`` with ``M`` one deep-MG V-cycle
    (:mod:`tdgl_tpu.ops.hexmg`), iterated until the relative residual meets
    ``tol``. Compared to MG-preconditioned CG each iteration drops the two
    dot products, the deflation projection, and the alpha/beta updates (one
    residual-norm reduction remains for the stopping test). Whether it wins
    depends on the V-cycle's contraction factor vs CG's acceleration —
    exposed as ``SolverOptions.poisson_solver`` for measurement.

    With ``fixed_iters`` set, exactly that many cycles run in a
    ``lax.fori_loop`` with **no** stopping test and no reductions inside the
    loop — the cheapest-per-iteration solve, and (like
    :func:`cg_solve_fixed`) a smooth map of its inputs, which the screening
    fixed point requires. The final residual norm is still computed once for
    the caller's failure gate. ``topup=True`` additionally continues
    tolerance-stopped cycles when the fixed count missed ``tol`` (cold
    starts); do NOT combine with the screening fixed point — the top-up
    makes the solve non-smooth.
    """
    from ..models.gtdgl_stencil import scalar_laplacian_sym
    from .hexmg import make_hexmg_apply

    rdtype = rhs.dtype
    valid = sten.valid.astype(rdtype)
    n_valid = jnp.maximum(jnp.sum(valid), 1.0)
    apply_mg = make_hexmg_apply(amg_omega)

    def project(v):
        return (v - jnp.sum(v * valid) / n_valid) * valid

    def apply_A(x):
        return -scalar_laplacian_sym(sten, x)

    b = project(-(sten.area.astype(rdtype) * rhs))
    x0 = project(mu_prev)
    b_norm_sq = jnp.maximum(jnp.sum(b * b), jnp.finfo(rdtype).tiny)
    r0 = b - apply_A(x0)
    eps = float(jnp.finfo(rdtype).eps)
    tol_eff = max(float(tol), 50.0 * eps)
    tol_sq = np.asarray(tol_eff, rdtype) ** 2 * b_norm_sq

    if fixed_iters is not None:
        def fbody(_, carry):
            x, r = carry
            x = x + apply_mg(amg, r)
            r = b - apply_A(x)
            return (x, r)

        x, r = jax.lax.fori_loop(0, fixed_iters, fbody, (x0, r0))
        if not topup:
            res = jnp.sqrt(jnp.sum(r * r) / b_norm_sq)
            return CGResult(project(x), jnp.int32(fixed_iters), res)

        # Tolerance-stopped top-up: a no-op (one residual reduction) when
        # the fixed cycles already met tol; restores robustness on cold
        # starts / hard steps.
        def tcond(state):
            _, r2, _, k = state
            return jnp.logical_and(r2 > tol_sq, k < maxiter)

        def tbody(state):
            x, _, r, k = state
            x = x + apply_mg(amg, r)
            r = b - apply_A(x)
            return (x, jnp.sum(r * r), r, k + 1)

        x, r2, _, k = jax.lax.while_loop(
            tcond, tbody,
            (x, jnp.sum(r * r), r, np.int32(fixed_iters)),
        )
        return CGResult(project(x), k, jnp.sqrt(r2 / b_norm_sq))

    def cond(state):
        _, r2, _, k = state
        return jnp.logical_and(r2 > tol_sq, k < maxiter)

    def body(state):
        x, _, r, k = state
        x = x + apply_mg(amg, r)
        r = b - apply_A(x)
        return (x, jnp.sum(r * r), r, k + 1)

    x, r2, _, k = jax.lax.while_loop(
        cond, body, (x0, jnp.sum(r0 * r0), r0, np.int32(0))
    )
    return CGResult(project(x), k, jnp.sqrt(r2 / b_norm_sq))


def solve_mu_poisson_grid(
    sten,
    rhs: jax.Array,
    mu_prev: jax.Array,
    tol: float = 1e-7,
    maxiter: int = 1000,
    amg=None,
    amg_omega: float = 0.6,
    fixed_iters: Optional[int] = None,
    topup: bool = False,
    sstep: bool = False,
) -> CGResult:
    """Grid (stencil-backend) variant of :func:`solve_mu_poisson`.

    Works on padded ``(Rp, Cp)`` arrays; the constant-mode deflation uses a
    masked mean so padding/masked sites stay exactly zero. ``topup`` (with
    ``fixed_iters``) appends tolerance-stopped iterations when the fixed
    count missed ``tol`` — see :func:`cg_solve_topup`. ``sstep`` (with
    ``fixed_iters=2`` and ``topup``) computes the fixed phase as one
    blocked 2D Krylov step — same math, 3 fewer reduction sync points
    (:func:`cg_solve_2step_topup`).
    """
    from ..models.gtdgl_stencil import scalar_laplacian_sym

    rdtype = rhs.dtype
    valid = sten.valid.astype(rdtype)
    n_valid = jnp.maximum(jnp.sum(valid), 1.0)

    def project(v):
        return (v - jnp.sum(v * valid) / n_valid) * valid

    def apply_A(x):
        return -scalar_laplacian_sym(sten, x)

    b = -(sten.area.astype(rdtype) * rhs)
    precond = None
    inv_diag = None
    if amg is not None:
        from .hexmg import make_hexmg_apply

        apply_mg = make_hexmg_apply(amg_omega)

        def precond(v):
            return apply_mg(amg, v)
    else:
        inv_diag = jnp.where(
            valid > 0,
            1.0 / jnp.maximum(sten.sym_diag.astype(rdtype),
                              jnp.finfo(rdtype).tiny),
            0.0,
        )
    if fixed_iters is not None:
        if topup and sstep and fixed_iters == 2 and precond is not None:
            return cg_solve_2step_topup(
                apply_A, b, mu_prev, tol=tol, maxiter=maxiter,
                precond=precond, project_fn=project,
            )
        if topup:
            return cg_solve_topup(
                apply_A, b, mu_prev, fixed_iters, tol=tol, maxiter=maxiter,
                precond_inv_diag=inv_diag, precond=precond,
                project_fn=project,
            )
        return cg_solve_fixed(
            apply_A, b, mu_prev, fixed_iters, precond_inv_diag=inv_diag,
            precond=precond, project_fn=project,
        )
    return cg_solve(
        apply_A, b, mu_prev, precond_inv_diag=inv_diag, tol=tol,
        maxiter=maxiter, precond=precond, project_fn=project,
    )


def solve_mu_poisson(
    op,
    rhs: jax.Array,
    mu_prev: jax.Array,
    tol: float = 1e-7,
    maxiter: int = 1000,
    amg=None,
    amg_omega: float = 0.6,
    fixed_iters: Optional[int] = None,
    topup: bool = False,
) -> CGResult:
    """Solve the scalar-potential Poisson equation ``L mu = rhs`` with
    ``L = diag(1/a) S``.

    Works on the symmetrized system ``(-S) mu = -diag(a) rhs`` (SPsD) with a
    Jacobi (or two-level AMG, if ``amg`` is given) preconditioner and warm
    start from the previous step's ``mu``.
    """
    from ..models.gtdgl import scalar_laplacian_sym

    rdtype = rhs.dtype
    areas = op.areas.astype(rdtype)

    def apply_A(x):
        return -scalar_laplacian_sym(op, x)

    b = -(areas * rhs)
    precond = None
    inv_diag = None
    if amg is not None:
        from .amg import make_amg_apply

        apply_amg = make_amg_apply(amg_omega)

        def precond(v):
            return apply_amg(apply_A, amg, v)
    else:
        # Jacobi diagonal of -S: precomputed edge-weight row sums.
        diag = op.w_sym_rowsum.astype(rdtype)
        inv_diag = 1.0 / jnp.maximum(diag, jnp.finfo(rdtype).tiny)
    if fixed_iters is not None:
        if topup:
            return cg_solve_topup(
                apply_A, b, mu_prev, fixed_iters, tol=tol, maxiter=maxiter,
                precond_inv_diag=inv_diag, deflate_constant=True,
                precond=precond,
            )
        return cg_solve_fixed(
            apply_A, b, mu_prev, fixed_iters, precond_inv_diag=inv_diag,
            deflate_constant=True, precond=precond,
        )
    return cg_solve(
        apply_A, b, mu_prev, precond_inv_diag=inv_diag, tol=tol,
        maxiter=maxiter, deflate_constant=True, precond=precond,
    )
