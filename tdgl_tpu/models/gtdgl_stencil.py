"""The generalized TDGL equations as hex-grid stencils (split complex).

Physics identical to :mod:`tdgl_tpu.models.gtdgl` (which follows the
reference ``docs/background.rst:241-357`` and
``tdgl/solver/solver.py:383-520``), re-expressed for structured meshes
(:mod:`tdgl_tpu.fv.stencil_operators`):

* All site fields are dense ``(Rp, Cp)`` arrays; edge fields are
  ``(3, Rp, Cp)`` (one slab per direction class). Neighbor access is
  ``jnp.roll`` — wrap-around reads are killed by zero weights at
  masked/padded entries.
* The order parameter is **split into real/imaginary arrays** instead of a
  complex dtype (XLA decomposes complex arithmetic into real operations
  anyway).

The stencils need no gathers, unlike the ELL forms of the unstructured
backend.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..device.hexmesh import EDGE_OFFSETS

_OFFS = tuple(EDGE_OFFSETS)


def shift_p(x: jax.Array, k: int) -> jax.Array:
    """Value at ``(r, c) + OFFSETS[k]`` (the positive-edge neighbor)."""
    dr, dc = _OFFS[k]
    return jnp.roll(x, (-dr, -dc), axis=(0, 1))


def shift_m(x: jax.Array, k: int) -> jax.Array:
    """Value at ``(r, c) - OFFSETS[k]`` (the negative-edge origin)."""
    dr, dc = _OFFS[k]
    return jnp.roll(x, (dr, dc), axis=(0, 1))


class LinkPhases(NamedTuple):
    """Link variables and their pre-shifted views.

    ``ur + i ui = U_k`` at the positive edge of each site; ``urm + i uim``
    is the same array shifted by ``-offset`` (the link of the negative
    incident edge, as seen from the head site). Precomputing the shifted
    views lets the chunk driver hoist them out of the scan entirely when the
    vector potential is static — the common case — removing ~6 rolls and the
    cos/sin evaluation from every step.
    """

    ur: jax.Array   # (3, Rp, Cp)
    ui: jax.Array
    urm: jax.Array
    uim: jax.Array


def edge_link_phases(sten, A_edge: jax.Array) -> LinkPhases:
    """Link variables ``U_k = exp(-i A.e_k)`` (plus shifted views).

    Args:
        sten: :class:`StencilOperators`.
        A_edge: ``(3, Rp, Cp, 2)`` vector potential at edge centers.
    """
    dirs = sten.edge_dirs.astype(A_edge.dtype)
    a = (A_edge[..., 0] * dirs[:, 0, None, None]
         + A_edge[..., 1] * dirs[:, 1, None, None])
    ur = jnp.cos(a)
    ui = -jnp.sin(a)
    urm = jnp.stack([shift_m(ur[k], k) for k in range(3)])
    uim = jnp.stack([shift_m(ui[k], k) for k in range(3)])
    return LinkPhases(ur, ui, urm, uim)


class FoldedLinkPhases(NamedTuple):
    """Link variables with the FV weights folded in (static-A fast path).

    ``wur + i wui = w_k U_k`` are the *weight-premultiplied* link tables:
    with a chunk-constant applied potential they are computed once outside
    the scan, so the covariant Laplacian reads 6 planes instead of 15 —
    the stencil step is HBM-bandwidth bound, so plane reads are the cost
    model. The negative-edge tables are NOT stored: ``w_m[k] U_m[k] ==
    roll(w[k] U[k])`` exactly (both factors are rolls), so the Laplacian
    derives the mirrored terms by rolling its positive-edge products
    (see :func:`covariant_laplacian`). ``ur``/``ui`` stay raw for the
    supercurrent. The folded tables may be stored bfloat16
    (``fold_link_phases(bf16=True)``): they multiply O(1) psi values,
    mixed-precision promotion keeps the accumulation in the working
    dtype, and the weight tables are exact lattice constants except at
    cut cells, so bf16 storage perturbs the discretization by ~4e-3
    relative — gate with the physics tests before enabling by default.
    """

    ur: jax.Array    # (3, Rp, Cp) — raw, for the supercurrent
    ui: jax.Array
    wur: jax.Array   # (3, Rp, Cp) — w * U (positive edges)
    wui: jax.Array


def fold_link_phases(sten, U: LinkPhases, bf16: bool = False
                     ) -> FoldedLinkPhases:
    """Premultiply the FV weights into the link phases (see
    :class:`FoldedLinkPhases`)."""
    dt = U.ur.dtype
    w = sten.w.astype(dt)
    store = jnp.bfloat16 if bf16 else dt
    return FoldedLinkPhases(
        ur=U.ur.astype(store),
        ui=U.ui.astype(store),
        wur=(w * U.ur).astype(store),
        wui=(w * U.ui).astype(store),
    )


class FactoredLinkPhases(NamedTuple):
    """Link variables in separable (rank-structured) form.

    For a *uniform* applied field in the symmetric gauge (and any other
    vector potential whose edge line integral separates), the per-edge
    phase on the structured lattice is ``theta_k(r, c) = f_k(r) + g_k(c)``
    exactly: the edge midpoint's y depends only on the row and its x only
    on the column plus a row-parity term (absorbed into ``f_k``). The
    link variables then reconstruct from four O(R)+O(C) trig *vectors*
    via the angle-addition identities::

        ur_k = cos f ⊗ cos g - sin f ⊗ sin g     (= cos theta)
        ui_k = -(sin f ⊗ cos g + cos f ⊗ sin g)  (= -sin theta)

    so the HBM-bound hot kernels read NO link planes at all — the psi
    update reads the 3 raw weight planes and the supercurrent none. The
    solver enables this automatically when a float64 separability check
    of the static applied potential passes (see
    ``TDGLSolver``/``grid_step``). Accuracy (f64 referee on real edges):
    the reconstruction carries the f32 rounding of the SPLIT angles
    (~(|f|+|g|) ulp radians — a few 1e-6 at unit scale for the bench
    field) vs ~|a| ulp for the direct evaluation — both at the f32
    angle-rounding floor, NOT bit-identical to each other.
    """

    cf: jax.Array  # (3, Rp) — cos f_k(r)
    sf: jax.Array  # (3, Rp) — sin f_k(r)
    cg: jax.Array  # (3, Cp) — cos g_k(c)
    sg: jax.Array  # (3, Cp) — sin g_k(c)


def edge_phase_angles(sten, A_edge: jax.Array) -> jax.Array:
    """Per-edge link phase angles ``a_k = A . e_k`` as ``(3, Rp, Cp)``."""
    dirs = sten.edge_dirs.astype(A_edge.dtype)
    return (A_edge[..., 0] * dirs[:, 0, None, None]
            + A_edge[..., 1] * dirs[:, 1, None, None])


def factor_link_phases(sten, A_edge: jax.Array) -> FactoredLinkPhases:
    """Build :class:`FactoredLinkPhases` from a separable applied potential.

    Splits ``a_k(r, c)`` into ``f_k(r) = a_k(r, 0)`` and ``g_k(c) =
    a_k(0, c) - a_k(0, 0)``. ONLY valid when the caller has verified
    separability (``a == f + g``); the solver checks in float64 at init.
    """
    a = edge_phase_angles(sten, A_edge)
    f = a[:, :, 0]                      # (3, Rp)
    g = a[:, 0, :] - a[:, 0, 0:1]      # (3, Cp)
    return FactoredLinkPhases(
        cf=jnp.cos(f), sf=jnp.sin(f), cg=jnp.cos(g), sg=jnp.sin(g),
    )


def _factored_u_k(U: FactoredLinkPhases, k: int, dt):
    """Reconstruct the (Rp, Cp) link planes ``ur_k``, ``ui_k`` from the
    factored row/col vectors (angle addition — no transcendentals)."""
    cf = U.cf[k].astype(dt)[:, None]
    sf = U.sf[k].astype(dt)[:, None]
    cg = U.cg[k].astype(dt)[None, :]
    sg = U.sg[k].astype(dt)[None, :]
    ur = cf * cg - sf * sg
    ui = -(sf * cg + cf * sg)
    return ur, ui


def covariant_laplacian(
    sten, U, pr: jax.Array, pi: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Covariant Laplacian ``(nabla - iA)^2 psi``, split re/im.

    Matches :func:`tdgl_tpu.models.gtdgl.covariant_laplacian` (identity rows
    at fixed sites) exactly on structured meshes. ``U`` may be
    :class:`LinkPhases` or the weight-folded :class:`FoldedLinkPhases`.
    """
    dt = pr.dtype
    acc_r = jnp.zeros_like(pr)
    acc_i = jnp.zeros_like(pi)
    folded = isinstance(U, FoldedLinkPhases)
    # Negative-edge terms are derived by rolling the positive-edge
    # products instead of reading separate shifted weight planes:
    # ``w_m[k] = roll(w[k])`` and ``urm[k] = roll(ur[k])`` by
    # construction, so e.g.
    # ``w_m*(urm*pr_m + uim*pi_m) == shift_m(w*(ur*pr + ui*pi), k)``
    # **bit-exactly** (the same float products, evaluated pre-roll).
    # This halves the link/weight plane reads of the HBM-bound psi
    # update: 6 planes instead of 12 (folded) / 9 instead of 15 (raw).
    for k in range(3):
        pr_p = shift_p(pr, k)
        pi_p = shift_p(pi, k)
        if folded:
            wur = U.wur[k].astype(dt)
            wui = U.wui[k].astype(dt)
            acc_r = acc_r + (wur * pr_p - wui * pi_p)
            acc_i = acc_i + (wur * pi_p + wui * pr_p)
            acc_r = acc_r + shift_m(wur * pr + wui * pi, k)
            acc_i = acc_i + shift_m(wur * pi - wui * pr, k)
        else:
            wk = sten.w[k].astype(dt)
            if isinstance(U, FactoredLinkPhases):
                ur, ui = _factored_u_k(U, k, dt)
            else:
                ur = U.ur[k].astype(dt)
                ui = U.ui[k].astype(dt)
            # positive edge: U_k psi_{+k}
            acc_r = acc_r + wk * (ur * pr_p - ui * pi_p)
            acc_i = acc_i + wk * (ur * pi_p + ui * pr_p)
            # negative edge: conj(U_k at -off) psi_{-off}
            acc_r = acc_r + shift_m(wk * (ur * pr + ui * pi), k)
            acc_i = acc_i + shift_m(wk * (ur * pi - ui * pr), k)
    diag = sten.sym_diag.astype(dt)
    inv_a = sten.inv_area.astype(dt)
    lap_r = (acc_r - pr * diag) * inv_a
    lap_i = (acc_i - pi * diag) * inv_a
    fixed = sten.fixed_mask.astype(dt)
    return ((1.0 - fixed) * lap_r + fixed * pr,
            (1.0 - fixed) * lap_i + fixed * pi)


def scalar_laplacian_sym(sten, x: jax.Array) -> jax.Array:
    """Symmetric Neumann Laplacian ``(S x)_i = sum_j w_ij (x_j - x_i)``.

    The negative-edge term is derived from the positive-edge weights:
    ``w_m[k] = roll(w[k])`` by construction (fv/stencil_operators.py), so
    ``w_m[k] * shift_m(x, k) == shift_m(w[k] * x, k)`` **bit-exactly**
    (same float products, rolled). Reading 3 weight planes instead of 6
    matters because the apply is HBM-bandwidth bound and sits inside
    every MG-CG iteration.
    """
    dt = x.dtype
    acc = jnp.zeros_like(x)
    for k in range(3):
        wk = sten.w[k].astype(dt)
        acc = acc + wk * shift_p(x, k)
        acc = acc + shift_m(wk * x, k)
    return acc - x * sten.sym_diag.astype(dt)


def gradient_on_edges(sten, x: jax.Array) -> jax.Array:
    """Discrete gradient on positive edges: ``(x_{+k} - x)/len_k``."""
    dt = x.dtype
    inv_len = sten.inv_len.astype(dt)
    return jnp.stack(
        [(shift_p(x, k) - x) * inv_len[k] for k in range(3)]
    )


def supercurrent_on_edges(
    sten, U: LinkPhases, pr: jax.Array, pi: jax.Array
) -> jax.Array:
    """Gauge-invariant supercurrent ``Im[psi_i^* (U psi_j - psi_i)]/len``
    on the (3, Rp, Cp) edge classes."""
    dt = pr.dtype
    out = []
    for k in range(3):
        pr_p = shift_p(pr, k)
        pi_p = shift_p(pi, k)
        if isinstance(U, FactoredLinkPhases):
            ur, ui = _factored_u_k(U, k, dt)
        else:
            ur = U.ur[k].astype(dt)
            ui = U.ui[k].astype(dt)
        grad_r = ur * pr_p - ui * pi_p - pr
        grad_i = ur * pi_p + ui * pr_p - pi
        out.append((pr * grad_i - pi * grad_r) * sten.inv_len[k].astype(dt))
    return jnp.stack(out)


def divergence_on_sites(sten, F_edge: jax.Array) -> jax.Array:
    """Divergence of a (3, Rp, Cp) edge flux onto sites."""
    dt = F_edge.dtype
    acc = jnp.zeros_like(F_edge[0])
    for k in range(3):
        dF = sten.dual[k].astype(dt) * F_edge[k]
        acc = acc + dF - shift_m(dF, k)
    return acc * sten.inv_area.astype(dt)


def edge_quantity_to_sites(sten, F_edge: jax.Array) -> jax.Array:
    """Average an edge flux onto site vectors in the reference's K0-unit
    convention (site value = mean over incident edges of ``F_e e_hat / 2``;
    cf. ``gtdgl.edge_quantity_to_sites`` / reference ``mesh.py:203-243``).

    Returns ``(Rp, Cp, 2)``.
    """
    dt = F_edge.dtype
    dirs = sten.edge_dirs.astype(dt)
    dirs = dirs / jnp.linalg.norm(dirs, axis=1, keepdims=True)
    sx = jnp.zeros_like(F_edge[0])
    sy = jnp.zeros_like(F_edge[0])
    for k in range(3):
        both = F_edge[k] + shift_m(F_edge[k], k)
        sx = sx + both * dirs[k, 0]
        sy = sy + both * dirs[k, 1]
    denom = 2.0 * sten.counts.astype(dt)
    return jnp.stack([sx / denom, sy / denom], axis=-1)


def neumann_boundary_term(sten, mu_boundary: jax.Array) -> jax.Array:
    """Inhomogeneous Neumann BC contribution to the mu-Poisson RHS
    (scatter of ``len_b/(2 a_i) * J_ext_b`` onto boundary sites)."""
    shape = sten.valid.shape
    vals = sten.nbl_vals.astype(mu_boundary.dtype) * mu_boundary[
        sten.nbl_col
    ]
    flat = jnp.zeros(shape[0] * shape[1], dtype=mu_boundary.dtype)
    return flat.at[sten.nbl_idx].add(vals).reshape(shape)


class PsiUpdateResult(NamedTuple):
    psi_r: jax.Array
    psi_i: jax.Array
    abs_sq_psi: jax.Array
    ok: jax.Array  # scalar bool: discriminant nonnegative on valid sites


def implicit_euler_psi(
    sten,
    U: LinkPhases,
    pr: jax.Array,
    pi: jax.Array,
    abs_sq_psi: jax.Array,
    mu: jax.Array,
    epsilon: jax.Array,
    gamma: float,
    u: float,
    dt,
) -> PsiUpdateResult:
    """One implicit-Euler update of the order parameter (split complex).

    Same closed-form quadratic and cancellation-free discriminant as
    :func:`tdgl_tpu.models.gtdgl.implicit_euler_psi`.
    """
    rdt = pr.dtype
    phase = mu * dt
    tr = jnp.cos(phase)
    ti = -jnp.sin(phase)   # U_t = tr + i ti
    half_g2 = 0.5 * gamma**2
    # z = U_t (gamma^2/2) psi
    zr = half_g2 * (tr * pr - ti * pi)
    zi = half_g2 * (tr * pi + ti * pr)
    lap_r, lap_i = covariant_laplacian(sten, U, pr, pi)
    coeff = (dt / u) * jnp.sqrt(1.0 + gamma**2 * abs_sq_psi)
    gr = pr + coeff * ((epsilon - abs_sq_psi) * pr + lap_r)
    gi = pi + coeff * ((epsilon - abs_sq_psi) * pi + lap_i)
    # w = z |psi|^2 + U_t g
    wr = zr * abs_sq_psi + tr * gr - ti * gi
    wi = zi * abs_sq_psi + tr * gi + ti * gr
    c = wr * zr + wi * zi
    two_c_1 = 2.0 * c + 1.0
    w2 = wr * wr + wi * wi
    im_wz = wr * zi - wi * zr
    discriminant = 1.0 + 4.0 * c - 4.0 * im_wz**2
    valid = sten.valid.astype(rdt)
    ok = jnp.all(jnp.where(valid > 0, discriminant, 1.0) >= 0.0)
    sqrt_disc = jnp.sqrt(jnp.maximum(discriminant, 0.0))
    new_sq = (2.0 * w2) / (two_c_1 + sqrt_disc)
    new_r = (wr - zr * new_sq) * valid
    new_i = (wi - zi * new_sq) * valid
    return PsiUpdateResult(new_r, new_i, new_sq * valid, ok)


def poisson_rhs(
    sten,
    supercurrent: jax.Array,
    dA_dt: jax.Array,
    neumann_term: jax.Array,
) -> jax.Array:
    """RHS of the mu-Poisson equation:
    ``div(J_s - dA/dt) - N_bl @ mu_boundary`` (reference ``solver.py:508``).

    ``neumann_term`` is the pre-scattered dense boundary contribution
    (:func:`neumann_boundary_term`).
    """
    return divergence_on_sites(sten, supercurrent - dA_dt) - neumann_term
