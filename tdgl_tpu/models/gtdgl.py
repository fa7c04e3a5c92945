"""The generalized TDGL equations as pure, jit-able JAX functions (ELL form).

This is the physics layer for unstructured meshes: every function here is a
pure array -> array map with static shapes, suitable for fusion inside a
single compiled step. The discrete equations follow the reference's
finite-volume formulation (``/root/reference/docs/background.rst:241-357``
and ``tdgl/solver/solver.py:383-520``); the implementation is gather-based
(ELL neighbor tables from :mod:`tdgl_tpu.fv.operators`) instead of SciPy
sparse matvecs.

Split-complex pair layout
-------------------------

Complex-valued fields are represented as REAL arrays with a trailing
``re/im`` axis of length 2 (``psi``: ``(N, 2)``, link variables ``U``:
``(E, 2)``) — never as a complex dtype. The paired gather ``x[(N,K)]`` of
an ``(N, 2)`` array brings both components in one gather. Whether native
complex64 would serve as well on the GPU has not been measured. The
structured-grid twin (:mod:`gtdgl_stencil`) uses the same
split-complex algebra over separate planes.

Conventions:

* ``psi`` is a ``(N, 2)`` re/im pair on sites, ``mu`` real on sites.
* Edge quantities (supercurrent, normal current, A) live on the canonical
  edge orientation ``r[edges[:,1]] - r[edges[:,0]]``.
* ``U_e = exp(-i A.e_direction)`` is the spatial link variable, stored as
  the pair ``(cos, -sin)``; the directed phase from site i to neighbor j
  is ``U_e`` if the edge's canonical direction points i -> j, else
  ``conj(U_e)``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


def pack(z: jax.Array) -> jax.Array:
    """Complex array -> ``(..., 2)`` re/im pair (host/test convenience)."""
    return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)


def unpack(pair: jax.Array) -> jax.Array:
    """``(..., 2)`` re/im pair -> complex array (host/test convenience).

    Do not use inside compiled solver programs — the whole point of the pair
    layout is that no complex dtype ever reaches the compiled program.
    """
    return jax.lax.complex(pair[..., 0], pair[..., 1])


def edge_link_phases(A_edge: jax.Array, edge_directions: jax.Array) -> jax.Array:
    """Link variables ``U_e = exp(-i A(r_e) . e)`` as ``(E, 2)`` pairs.

    Args:
        A_edge: ``(E, 2)`` vector potential at edge centers.
        edge_directions: ``(E, 2)`` unnormalized edge vectors.
    """
    a = jnp.sum(A_edge * edge_directions, axis=1)
    return jnp.stack([jnp.cos(a), -jnp.sin(a)], axis=-1)


def covariant_laplacian(op, U: jax.Array, psi: jax.Array) -> jax.Array:
    """Covariant Laplacian ``(nabla - iA)^2 psi`` on sites, ``(N, 2)``.

    ``(L psi)_i = (1/a_i) sum_j (w_ij) (U_ij psi_j - psi_i)`` with
    ``w_ij = dual_len/edge_len`` (``background.rst: laplacian-psi``).
    Rows for fixed (terminal) sites become identity rows, matching the
    reference's Dirichlet handling (``operators.py:170-181``).
    """
    rdt = psi.dtype
    U_slot = U[op.nbr_edge]                  # (N, K, 2) paired f32 gather
    ur = U_slot[..., 0]
    # conj for slots whose canonical edge points j -> i: sign flips im.
    ui = U_slot[..., 1] * op.nbr_sign.astype(rdt)
    psi_nbr = psi[op.nbr_site]               # (N, K, 2)
    pr_n = psi_nbr[..., 0]
    pi_n = psi_nbr[..., 1]
    w = op.w_lap.astype(rdt)
    rowsum = op.w_lap_rowsum.astype(rdt)
    pr = psi[..., 0]
    pi = psi[..., 1]
    lap_r = jnp.sum(w * (ur * pr_n - ui * pi_n), axis=1) - pr * rowsum
    lap_i = jnp.sum(w * (ur * pi_n + ui * pr_n), axis=1) - pi * rowsum
    fixed = op.fixed_mask.astype(rdt)
    return jnp.stack(
        [(1.0 - fixed) * lap_r + fixed * pr,
         (1.0 - fixed) * lap_i + fixed * pi],
        axis=-1,
    )


def scalar_laplacian_sym(op, x: jax.Array) -> jax.Array:
    """Symmetric (area-unscaled) Neumann Laplacian ``(S x)_i = sum_j w_ij (x_j - x_i)``.

    The mu-Poisson operator is ``L = diag(1/a) S``; CG solves with the
    symmetric ``S`` directly.
    """
    w = op.w_sym.astype(x.dtype)
    return (jnp.sum(w * x[op.nbr_site], axis=1)
            - x * op.w_sym_rowsum.astype(x.dtype))


def gradient_on_edges(op, x: jax.Array) -> jax.Array:
    """Discrete gradient of a site scalar, on edges: ``(x_j - x_i)/e_ij``."""
    e0 = op.edges[:, 0]
    e1 = op.edges[:, 1]
    return (x[e1] - x[e0]) / op.edge_lengths.astype(x.dtype)


def supercurrent_on_edges(op, U: jax.Array, psi: jax.Array) -> jax.Array:
    """Gauge-invariant supercurrent ``J_s = Im[psi_i^* (U psi_j - psi_i)]/e``
    on edges (reference ``operators.py:385-394``)."""
    rdt = psi.dtype
    psi0 = psi[op.edges[:, 0]]               # (E, 2) paired gathers
    psi1 = psi[op.edges[:, 1]]
    ur, ui = U[..., 0], U[..., 1]
    inv_len = 1.0 / op.edge_lengths.astype(rdt)
    grad_r = (ur * psi1[..., 0] - ui * psi1[..., 1] - psi0[..., 0]) * inv_len
    grad_i = (ur * psi1[..., 1] + ui * psi1[..., 0] - psi0[..., 1]) * inv_len
    return psi0[..., 0] * grad_i - psi0[..., 1] * grad_r


def divergence_on_sites(op, F_edge: jax.Array) -> jax.Array:
    """Divergence of an edge flux onto sites:
    ``(div F)_i = (1/a_i) sum_j F_ij s_ij`` (``background.rst: divergence``)."""
    w = op.w_div.astype(F_edge.dtype)
    return jnp.sum(w * F_edge[op.nbr_edge], axis=1)


def neumann_boundary_term(op, mu_boundary: jax.Array, n_sites: int) -> jax.Array:
    """Inhomogeneous Neumann BC contribution to the mu-Poisson RHS:
    scatter ``len_b/(2 a_i) * J_ext_b`` onto the boundary sites
    (reference ``operators.py:188-230``)."""
    vals = op.nbl_vals.astype(mu_boundary.dtype) * mu_boundary[op.nbl_cols]
    return jnp.zeros(n_sites, dtype=mu_boundary.dtype).at[op.nbl_rows].add(vals)


def edge_quantity_to_sites(op, F_edge: jax.Array, n_sites: int) -> jax.Array:
    """Average an edge flux onto site vectors, in the reference's K0-unit
    convention (``mesh.py:203-243``): site value = (1/2) mean over incident
    edges of ``F_e e_hat`` — which converts edge values in J0/4 units to site
    vectors in K0 units."""
    dirs = (op.edge_directions
            / jnp.linalg.norm(op.edge_directions, axis=1, keepdims=True)
            ).astype(F_edge.dtype)
    flux = F_edge[:, None] * dirs
    e0, e1 = op.edges[:, 0], op.edges[:, 1]
    sums = (
        jnp.zeros((n_sites, 2), dtype=F_edge.dtype)
        .at[e0].add(flux)
        .at[e1].add(flux)
    )
    counts = (
        jnp.zeros(n_sites, dtype=F_edge.dtype)
        .at[e0].add(1.0)
        .at[e1].add(1.0)
    )
    return sums / (2.0 * jnp.maximum(counts, 1.0))[:, None]


class PsiUpdateResult(NamedTuple):
    psi: jax.Array          # (N, 2) re/im pair
    abs_sq_psi: jax.Array   # (N,)
    ok: jax.Array           # scalar bool: discriminant nonnegative everywhere


def implicit_euler_psi(
    op,
    U: jax.Array,
    psi: jax.Array,
    abs_sq_psi: jax.Array,
    mu: jax.Array,
    epsilon: jax.Array,
    gamma: float,
    u: float,
    dt: jax.Array,
) -> PsiUpdateResult:
    """One implicit-Euler update of the order parameter (split complex).

    Solves the closed-form quadratic for ``|psi^{n+1}|^2``
    (``background.rst: quad-root``):

    ``|psi^{n+1}|^2 = 2|w|^2 / (2c+1 + sqrt((2c+1)^2 - 4|z|^2|w|^2))``

    with ``z = exp(-i mu dt) (gamma^2/2) psi`` and
    ``w = z|psi|^2 + exp(-i mu dt)[psi + (dt/u) sqrt(1+gamma^2|psi|^2)
    ((eps - |psi|^2) psi + (nabla-iA)^2 psi)]``, then
    ``psi^{n+1} = w - z |psi^{n+1}|^2``.

    ``ok`` is False if the discriminant is negative anywhere (time step too
    large; caller retries with smaller dt). Same algebra as the structured
    twin :func:`gtdgl_stencil.implicit_euler_psi`.
    """
    # NOTE: dt stays a (possibly weak-typed) scalar; eager jnp.asarray of a
    # python float would create a 0-d device constant, which some backends
    # cannot fetch during lowering.
    pr = psi[..., 0]
    pi = psi[..., 1]
    phase = mu * dt
    tr = jnp.cos(phase)
    ti = -jnp.sin(phase)   # U_t = tr + i ti
    half_g2 = 0.5 * gamma**2
    # z = U_t (gamma^2/2) psi
    zr = half_g2 * (tr * pr - ti * pi)
    zi = half_g2 * (tr * pi + ti * pr)
    lap = covariant_laplacian(op, U, psi)
    coeff = (dt / u) * jnp.sqrt(1.0 + gamma**2 * abs_sq_psi)
    gr = pr + coeff * ((epsilon - abs_sq_psi) * pr + lap[..., 0])
    gi = pi + coeff * ((epsilon - abs_sq_psi) * pi + lap[..., 1])
    # w = z |psi|^2 + U_t g
    wr = zr * abs_sq_psi + tr * gr - ti * gi
    wi = zi * abs_sq_psi + tr * gi + ti * gr
    c = wr * zr + wi * zi
    two_c_1 = 2.0 * c + 1.0
    w2 = wr * wr + wi * wi
    # The textbook discriminant (2c+1)^2 - 4|z|^2|w|^2 suffers catastrophic
    # cancellation in float32 (both terms are O(gamma^4)). Using
    # c^2 - |z|^2|w|^2 = Re(conj(w) z)^2 - |conj(w) z|^2 = -Im(conj(w) z)^2,
    # it equals 1 + 4c - 4 Im(conj(w) z)^2 exactly — no large squares.
    im_wz = wr * zi - wi * zr
    discriminant = 1.0 + 4.0 * c - 4.0 * im_wz**2
    ok = jnp.all(discriminant >= 0.0)
    sqrt_disc = jnp.sqrt(jnp.maximum(discriminant, 0.0))
    new_sq = (2.0 * w2) / (two_c_1 + sqrt_disc)
    new_psi = jnp.stack([wr - zr * new_sq, wi - zi * new_sq], axis=-1)
    return PsiUpdateResult(new_psi, new_sq, ok)


def poisson_rhs(
    op,
    supercurrent: jax.Array,
    dA_dt: jax.Array,
    mu_boundary: jax.Array,
) -> jax.Array:
    """RHS of the mu-Poisson equation:
    ``div(J_s - dA/dt) - N_bl @ mu_boundary`` (reference ``solver.py:508``)."""
    n = op.areas.shape[0]
    return divergence_on_sites(op, supercurrent - dA_dt) - neumann_boundary_term(
        op, mu_boundary, n
    )
