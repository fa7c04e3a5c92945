"""Screening (induced vector potential) as an exact FFT convolution.

The reference evaluates ``A[e] = sum_s J_w[s] / |r_e - r_s|`` as a dense
O(E x S) pairwise sum (Numba/CuPy kernels, ``tdgl/solver/screening.py``),
and so does :mod:`tdgl_tpu.ops.screening` (XLA). On a **structured lattice
mesh** the
sum collapses: site positions are an affine function of the grid indices and
each edge class's centers sit at a fixed offset (half the class direction)
from the lattice points, so the distance depends only on the index
displacement:

    |ec_k(r, c) - pos(r + dr, c + dc)| = |e_k / 2 - L (dr, dc)|

with ``L`` the lattice index->cartesian map. The pairwise sum is therefore a
translation-invariant convolution per edge class, computed exactly with
zero-padded real FFTs in O(N log N) instead of O(N^2) — ~1000x less
arithmetic at the 50k-site benchmark scale, on top of avoiding the giant
pairwise intermediate entirely. Masked/padded sites carry zero weight, so
the clipped film geometry is handled for free.

Kernels (``1/dist`` tables and their rffts) are precomputed on the host once
per mesh.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class FFTScreeningData(NamedTuple):
    """Precomputed convolution kernels (a pytree).

    The rfft2 spectra of the per-edge-class ``1/dist`` kernels on the
    zero-padding-doubled grid, stored as **separate real/imaginary arrays**
    (``(3, 2*Rp, Cp + 1)`` each); the spectrum product runs in
    split-complex arithmetic.
    """

    Ghat_re: jax.Array
    Ghat_im: jax.Array
    # Site-evaluation kernel (``1/dist`` between lattice points, with the
    # self term moment-matched against the edge-class kernels — see
    # build_fft_screening): ``(2*Rp, Cp + 1)`` spectra for the cheaper
    # evaluate-at-sites-then-interpolate screening path
    # (:func:`induced_vector_potential_fft_site`). ``None`` when not built.
    G0hat_re: Optional[jax.Array] = None
    G0hat_im: Optional[jax.Array] = None


def build_fft_screening(sten, maps, grid,
                        dtype=np.float32) -> FFTScreeningData:
    """Build the per-edge-class convolution kernels for a structured mesh.

    Args:
        sten: Host :class:`StencilOperators` (for ``edge_dirs``).
        maps: :class:`GridMaps` (padded shape).
        grid: The mesh's :class:`HexGrid` (dimensionless spacing).
        dtype: Real dtype of the solve (sets the spectrum precision).
    """
    Rp, Cp = maps.shape
    h = float(grid.spacing)
    R2, C2 = 2 * Rp, 2 * Cp
    # Index displacement grids in circular-convolution layout: frequency bin
    # i represents displacement i for i < Rp and i - 2*Rp for i >= Rp.
    dr = np.arange(R2)
    dr = np.where(dr >= Rp, dr - R2, dr).astype(np.float64)
    dc = np.arange(C2)
    dc = np.where(dc >= Cp, dc - C2, dc).astype(np.float64)
    DR, DC = np.meshgrid(dr, dc, indexing="ij")
    # Lattice map: pos(r, c) = origin + ((c + r/2) h, r (sqrt(3)/2) h).
    dx = (DC + 0.5 * DR) * h
    dy = DR * (np.sqrt(3) / 2) * h
    rdt = np.float64 if dtype == np.float64 else np.float32
    dirs = np.asarray(sten.edge_dirs, np.float64)  # (3, 2), length h
    G = np.empty((3, R2, C2), rdt)
    for k in range(3):
        # A[e] = sum_s G[e - s] Jw[s] with G[delta] =
        # 1/|L(delta) + e_k/2| (ec(e) - pos(s) for delta = e - s).
        ox, oy = 0.5 * dirs[k]
        dist = np.sqrt((ox + dx) ** 2 + (oy + dy) ** 2)
        # Never singular: edge centers are never lattice points.
        G[k] = (1.0 / dist).astype(rdt)
    Ghat = np.fft.rfft2(G, axes=(1, 2))
    # Site-evaluation kernel for the cheaper interpolated screening path
    # (induced_vector_potential_*_site): distances between LATTICE POINTS,
    # singular at delta = 0. The origin tap is ZERO here — the self
    # interaction and every other near-field discrepancy of the
    # interpolated evaluation are carried exactly by the per-class tap
    # stencils (build_site_interp_taps), whose origin tap also
    # moment-matches the uncorrected far tail.
    dist0 = np.sqrt(dx**2 + dy**2)
    dist0[0, 0] = np.inf
    G0 = 1.0 / dist0
    G0hat = np.fft.rfft2(G0.astype(rdt))
    return FFTScreeningData(
        Ghat_re=jnp.asarray(Ghat.real.astype(rdt)),
        Ghat_im=jnp.asarray(Ghat.imag.astype(rdt)),
        G0hat_re=jnp.asarray(G0hat.real.astype(rdt)),
        G0hat_im=jnp.asarray(G0hat.imag.astype(rdt)),
    )


def induced_vector_potential_fft(
    fft_data: FFTScreeningData, sten, J_weighted: jax.Array
) -> jax.Array:
    """Induced vector potential on all edge classes via FFT convolution.

    Args:
        fft_data: :class:`FFTScreeningData` for this mesh.
        sten: :class:`StencilOperators` (device arrays; for the edge mask).
        J_weighted: ``(Rp, Cp, 2)`` site current density times site area and
            physical prefactor (zero at masked sites).

    Returns:
        ``(3, Rp, Cp, 2)`` float32 induced vector potential at edge centers
        (zero at masked edges).
    """
    rdtype = J_weighted.dtype
    Rp, Cp = J_weighted.shape[:2]
    # A_k[e] = sum_s G_k[e - s] Jw[s] per cartesian component: zero-pad Jw,
    # multiply spectra (split-complex — see FFTScreeningData), transform
    # back, take the unaliased quadrant.
    Jw = jnp.pad(J_weighted, ((0, Rp), (0, Cp), (0, 0)))
    Jhat = jnp.fft.rfft2(Jw, axes=(0, 1))          # (2Rp, Cp+1, 2)
    jr = Jhat.real[None]
    ji = Jhat.imag[None]
    gr = fft_data.Ghat_re[:, :, :, None].astype(jr.dtype)
    gi = fft_data.Ghat_im[:, :, :, None].astype(jr.dtype)
    prod = jax.lax.complex(gr * jr - gi * ji, gr * ji + gi * jr)
    A = jnp.fft.irfft2(prod, s=(2 * Rp, 2 * Cp), axes=(1, 2))
    A = A[:, :Rp, :Cp, :]
    return (A * sten.edge_valid[..., None].astype(A.dtype)).astype(rdtype)


# Cubic midpoint-interpolation weights along the edge direction:
# value at s + off/2 from samples at s + j*off, j in {-1, 0, 1, 2}.
# O(h^4) for smooth fields — the induced potential is a 1/r convolution
# of the current, smooth away from the source cells; the near-field
# residual is corrected exactly by the per-class tap stencils
# (build_site_interp_taps).
_CUBIC_W = ((-1, -1.0 / 16), (0, 9.0 / 16), (1, 9.0 / 16), (2, -1.0 / 16))


def build_site_interp_taps(sten, maps, grid, n_taps: int = 12):
    """Per-edge-class correction stencils for the site-evaluated path.

    The site path approximates the exact per-class convolution ``G_k * J``
    by ``H_k * J`` with ``H_k`` the cubic midpoint interpolation of the
    site kernel ``G0`` (see ``_CUBIC_W``). The difference ``D_k = G_k -
    H_k`` is dominated by the source cells nearest the edge (it decays
    like h^2/|delta|^3): keep the ``n_taps`` largest-magnitude taps per
    class exactly and fold the remaining tail's SUM onto the origin tap
    (so a locally constant current stays exact — the same moment matching
    as the self term). Measured residual at 12 taps: ~3e-4 relative L-inf
    for smooth currents — the float32 screening precision floor.

    Returns a static (hashable) tuple ``((( (dr, dc), value ), ...) x 3)``
    for :class:`StepConfig`, or ``None`` when the valid region sits too
    close to the padded-grid boundary for the tap/interp rolls to be
    wrap-safe (the caller then keeps the exact per-class path).
    """
    Rp, Cp = maps.shape
    h = float(grid.spacing)
    R2, C2 = 2 * Rp, 2 * Cp
    dr = np.arange(R2)
    dr = np.where(dr >= Rp, dr - R2, dr).astype(np.float64)
    dc = np.arange(C2)
    dc = np.where(dc >= Cp, dc - C2, dc).astype(np.float64)
    DR, DC = np.meshgrid(dr, dc, indexing="ij")
    dx = (DC + 0.5 * DR) * h
    dy = DR * (np.sqrt(3) / 2) * h
    dirs = np.asarray(sten.edge_dirs, np.float64)
    dist0 = np.sqrt(dx**2 + dy**2)
    dist0[0, 0] = np.inf
    G0 = 1.0 / dist0
    from ..device.hexmesh import EDGE_OFFSETS

    valid = np.asarray(sten.valid, bool)
    rows = np.where(valid.any(axis=1))[0]
    cols = np.where(valid.any(axis=0))[0]
    if len(rows) == 0:
        return None
    m_lo, m_hi = int(rows.min()), int(Rp - 1 - rows.max())
    m_cl, m_ch = int(cols.min()), int(Cp - 1 - cols.max())

    def tap_safe(a, b):
        # The tap correction reads ``Jw[s - (a, b)]`` circularly at valid
        # edge outputs. A wrap on an axis is harmful only when BOTH the
        # wrapped output rows/cols contain valid edges AND the wrapped
        # input rows/cols contain valid sites (nonzero J) — i.e. the
        # offset exceeds both margins of that axis.
        return (abs(a) <= max(m_lo, m_hi)) and (abs(b) <= max(m_cl, m_ch))

    def interp_safe(p, q):
        # Interpolation reads ``A_site[s + (p, q)]`` — A_site is nonzero
        # (and exact) at EVERY in-grid point, so any wrapped read on a
        # valid edge output is harmful: the shift must stay in-grid for
        # the whole valid region, direction by direction.
        return (((-p) <= m_lo if p < 0 else p <= m_hi)
                and ((-q) <= m_cl if q < 0 else q <= m_ch))

    taps = []
    for k, (orr, occ) in enumerate(EDGE_OFFSETS):
        # Interpolation reads A_site at s + j*off for j in {-1, .., 2}:
        # require in-grid reads for every valid edge (A_site is exact at
        # every grid point, including invalid sites, so only true
        # wrap-around is unsafe).
        for j, _w in _CUBIC_W:
            if not interp_safe(j * orr, j * occ):
                return None
        ox, oy = 0.5 * dirs[k]
        Gk = 1.0 / np.sqrt((ox + dx) ** 2 + (oy + dy) ** 2)
        Hk = np.zeros_like(G0)
        for j, w in _CUBIC_W:
            Hk += w * np.roll(G0, (-j * orr, -j * occ), axis=(0, 1))
        D = Gk - Hk
        order = np.argsort(np.abs(D).ravel())[::-1]
        chosen = []
        tail = float(D.sum())
        for flat in order[: 4 * n_taps]:
            if len(chosen) >= n_taps:
                break
            a = int(flat // C2)
            b = int(flat % C2)
            sa = a if a < Rp else a - R2
            sb = b if b < Cp else b - C2
            if not tap_safe(sa, sb):
                continue
            chosen.append(((sa, sb), float(D[a, b])))
            tail -= float(D[a, b])
        # Fold the uncorrected tail onto the origin tap (moment match).
        chosen = [((a, b), v + (tail if (a, b) == (0, 0) else 0.0))
                  for (a, b), v in chosen]
        if not any(ab == (0, 0) for ab, _ in chosen):
            chosen.append(((0, 0), tail))
        taps.append(tuple(chosen))
    return tuple(taps)


def _interp_site_to_edges(sten, A_site: jax.Array, J_weighted: jax.Array,
                          taps) -> jax.Array:
    """Cubic-interpolate site potentials onto the 3 edge classes and add
    the exact near-field tap corrections (``build_site_interp_taps``).
    Wrap-around reads are precluded by the build-time safety check; any
    residual boundary reads are killed by ``edge_valid``.
    """
    from ..device.hexmesh import EDGE_OFFSETS

    dt = A_site.dtype
    outs = []
    for k, (dr, dc) in enumerate(EDGE_OFFSETS):
        acc = None
        for j, w in _CUBIC_W:
            term = jnp.roll(A_site, (-j * dr, -j * dc), axis=(0, 1))
            acc = w * term if acc is None else acc + w * term
        for (a, b), v in taps[k]:
            acc = acc + jnp.asarray(v, dt) * jnp.roll(
                J_weighted, (a, b), axis=(0, 1))
        outs.append(acc)
    A = jnp.stack(outs, axis=0)                          # (3, Rp, Cp, 2)
    return A * sten.edge_valid[..., None].astype(A.dtype)


def induced_vector_potential_fft_site(
    fft_data: FFTScreeningData, sten, J_weighted: jax.Array, taps
) -> jax.Array:
    """Site-evaluated variant of :func:`induced_vector_potential_fft`.

    Evaluates the induced potential at the LATTICE SITES with a single
    kernel, cubic-interpolates to the 3 edge classes, and corrects the
    near field exactly with the static per-class tap stencils ``taps``
    (:func:`build_site_interp_taps`) — instead of convolving each edge
    class exactly: 1/3 of the inverse-transform work and intermediates.
    Residual: ~3e-4 relative L-inf for smooth currents (measured) — the
    float32 screening precision floor's order.
    """
    rdtype = J_weighted.dtype
    Rp, Cp = J_weighted.shape[:2]
    Jw = jnp.pad(J_weighted, ((0, Rp), (0, Cp), (0, 0)))
    Jhat = jnp.fft.rfft2(Jw, axes=(0, 1))          # (2Rp, Cp+1, 2)
    gr = fft_data.G0hat_re[:, :, None].astype(Jhat.real.dtype)
    gi = fft_data.G0hat_im[:, :, None].astype(Jhat.real.dtype)
    prod = jax.lax.complex(gr * Jhat.real - gi * Jhat.imag,
                           gr * Jhat.imag + gi * Jhat.real)
    A = jnp.fft.irfft2(prod, s=(2 * Rp, 2 * Cp), axes=(0, 1))
    A_site = A[:Rp, :Cp, :]
    return _interp_site_to_edges(sten, A_site, J_weighted,
                                 taps).astype(rdtype)
