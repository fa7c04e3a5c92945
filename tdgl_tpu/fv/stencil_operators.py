"""Finite-volume operators as dense hex-grid stencils.

For meshes generated on a clipped triangular lattice
(:mod:`tdgl_tpu.device.hexmesh`), every site sits at a grid node ``(r, c)``
and every edge belongs to one of three direction classes. All FV operators
then become 6-point stencils over dense ``(rows, cols)`` arrays — array
shifts and elementwise math only, no gathers (the ELL tables of
:mod:`tdgl_tpu.fv.operators`, the general-mesh backend, gather every
neighbor).

Same discrete equations as the reference (``tdgl/finite_volume/operators.py``
builds them as SciPy sparse matrices); only the data layout differs.

Conventions:

* Arrays are padded to ``(Rp, Cp)`` with ``Rp % 32 == 0`` and
  ``Cp % 128 == 0``; padded/masked entries carry zero weights.
* Edge class ``k`` covers edges from ``(r, c)`` to ``(r, c) + OFFSETS[k]``
  with ``OFFSETS = ((0, 1), (1, 0), (1, -1))``; the canonical mesh edge
  orientation (low site index -> high) coincides with the positive offset
  direction, so edge-vector quantities transfer sign-faithfully.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..device.hexmesh import EDGE_OFFSETS, HexGrid
from .mesh import Mesh


class StencilOperators(NamedTuple):
    """Static stencil tables for one structured mesh (device pytree).

    Shapes: ``G = (Rp, Cp)`` padded grid, ``3xG`` per-edge-class.
    """

    valid: np.ndarray        # G — 1.0 at real sites
    area: np.ndarray         # G — Voronoi cell areas (0 at invalid)
    inv_area: np.ndarray     # G — 1/area (0 at invalid)
    site_x: np.ndarray       # G — site positions (centroid at invalid)
    site_y: np.ndarray       # G
    edge_valid: np.ndarray   # (3,) + G — 1.0 at real edges
    w: np.ndarray            # (3,) + G — dual_len/edge_len (0 at invalid)
    w_m: np.ndarray          # (3,) + G — w shifted by -offset (negative-edge
                             # weight seen from the head site); precomputed so
                             # the hot loop never rolls static tables
    dual: np.ndarray         # (3,) + G — dual edge lengths (0 at invalid)
    inv_len: np.ndarray      # (3,) + G — 1/edge_len (0 at invalid)
    ec_x: np.ndarray         # (3,) + G — edge centers (centroid at invalid)
    ec_y: np.ndarray         # (3,) + G
    sym_diag: np.ndarray     # G — sum of incident w (diag of -S)
    counts: np.ndarray       # G — number of incident edges (>=1 clamp)
    fixed_mask: np.ndarray   # G — 1.0 at terminal (Dirichlet) sites
    edge_dirs: np.ndarray    # (3, 2) — class direction vectors (length h)
    # Neumann boundary scatter (flat indices into Rp*Cp)
    nbl_idx: np.ndarray      # (2B,) int32
    nbl_col: np.ndarray      # (2B,) int32 — boundary-edge ordinal
    nbl_vals: np.ndarray     # (2B,) — len_b / (2 a_i)


@dataclass(frozen=True)
class GridMaps:
    """Host-side index maps between mesh vectors and grid arrays."""

    shape: Tuple[int, int]         # (Rp, Cp)
    site_flat: np.ndarray          # (N,) — flat grid index of each site
    edge_flat: np.ndarray          # (E,) — k*Rp*Cp + flat grid index
    n_sites: int
    n_edges: int

    def site_to_grid(self, v: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """Scatter a per-site vector (possibly with trailing dims) onto the
        grid."""
        out = np.full((self.shape[0] * self.shape[1],) + v.shape[1:], fill,
                      dtype=v.dtype)
        out[self.site_flat] = v
        return out.reshape(self.shape + v.shape[1:])

    def edge_to_grid(self, v: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """Scatter a per-edge vector onto the 3-class grid."""
        out = np.full((3 * self.shape[0] * self.shape[1],) + v.shape[1:],
                      fill, dtype=v.dtype)
        out[self.edge_flat] = v
        return out.reshape((3,) + self.shape + v.shape[1:])

    def grid_to_site(self, g: np.ndarray) -> np.ndarray:
        """Gather a grid array back into a per-site vector."""
        return g.reshape((self.shape[0] * self.shape[1],) + g.shape[2:])[
            self.site_flat
        ]

    def grid_to_edge(self, g: np.ndarray) -> np.ndarray:
        """Gather a 3-class grid array back into a per-edge vector."""
        return g.reshape((3 * self.shape[0] * self.shape[1],) + g.shape[3:])[
            self.edge_flat
        ]


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def build_stencil_operators(
    mesh: Mesh,
    fixed_sites: Optional[np.ndarray] = None,
    dtype=np.float32,
) -> Tuple[StencilOperators, GridMaps]:
    """Build stencil tables for a structured mesh (``mesh.grid`` required).

    The geometric quantities (Voronoi areas, dual/edge lengths) come from the
    actual triangulation — identical to what :func:`fv.operators.
    build_operators` uses — so the stencil and ELL backends discretize the
    same equations exactly.
    """
    grid: HexGrid = mesh.grid
    if grid is None or grid.edge_krc is None:
        raise ValueError(
            "mesh has no grid metadata; generate it with "
            "Device.make_mesh(structured=True)"
        )
    em = mesh.edge_mesh
    R, C = grid.rows, grid.cols
    # Rows pad to 32: the multigrid hierarchy halves the grid per level,
    # so divisibility depth directly sets how small (and cheap) the dense
    # coarsest solve can get.
    Rp = _pad_to(R, 32)
    Cp = _pad_to(C, 128)
    shape = (Rp, Cp)
    n_flat = Rp * Cp

    site_flat = (grid.site_rc[:, 0] * Cp + grid.site_rc[:, 1]).astype(
        np.int64
    )
    k, er, ec_ = grid.edge_krc.T
    edge_flat = (k * n_flat + er * Cp + ec_).astype(np.int64)
    maps = GridMaps(
        shape=shape, site_flat=site_flat, edge_flat=edge_flat,
        n_sites=len(mesh.sites), n_edges=len(em.edges),
    )

    center = np.asarray(mesh.sites).mean(axis=0)

    valid = maps.site_to_grid(np.ones(len(mesh.sites), dtype=dtype))
    area = maps.site_to_grid(np.asarray(mesh.areas, dtype=dtype))
    inv_area = np.where(valid > 0, 1.0 / np.maximum(area, 1e-30), 0.0)
    inv_area = inv_area.astype(dtype)
    site_x = maps.site_to_grid(
        np.asarray(mesh.sites[:, 0], dtype=dtype), fill=center[0]
    )
    site_y = maps.site_to_grid(
        np.asarray(mesh.sites[:, 1], dtype=dtype), fill=center[1]
    )

    edge_valid = maps.edge_to_grid(np.ones(len(em.edges), dtype=dtype))
    lengths = np.asarray(em.edge_lengths, dtype=dtype)
    duals = np.asarray(em.dual_edge_lengths, dtype=dtype)
    w = maps.edge_to_grid((duals / lengths).astype(dtype))
    dual = maps.edge_to_grid(duals)
    inv_len = maps.edge_to_grid((1.0 / lengths).astype(dtype))
    centers = np.asarray(em.centers, dtype=dtype)
    ec_x = maps.edge_to_grid(centers[:, 0], fill=center[0])
    ec_y = maps.edge_to_grid(centers[:, 1], fill=center[1])

    # Incident-edge reductions: positive edges live at the site; negative
    # edges at (r, c) - offset.
    sym_diag = np.zeros(shape, dtype=dtype)
    counts = np.zeros(shape, dtype=dtype)
    w_m = np.zeros_like(w)
    for kk, (dr, dc) in enumerate(EDGE_OFFSETS):
        w_m[kk] = np.roll(w[kk], (dr, dc), axis=(0, 1))
        sym_diag += w[kk] + w_m[kk]
        counts += edge_valid[kk]
        counts += np.roll(edge_valid[kk], (dr, dc), axis=(0, 1))
    counts = np.maximum(counts, 1.0)

    fixed_mask = np.zeros(shape, dtype=dtype)
    if fixed_sites is not None and len(fixed_sites):
        fixed_mask.reshape(-1)[site_flat[np.asarray(fixed_sites)]] = 1.0

    # Class direction vectors (lattice is exact, so one vector per class).
    h = grid.spacing
    edge_dirs = h * np.array(
        [[1.0, 0.0],
         [0.5, np.sqrt(3) / 2],
         [-0.5, np.sqrt(3) / 2]], dtype=dtype,
    )

    # Neumann boundary scatter (cf. fv.operators build: nbl arrays).
    b_ix = np.asarray(em.boundary_edge_indices, dtype=np.int64)
    b_edges = np.asarray(em.edges)[b_ix]
    b_lengths = lengths[b_ix]
    areas_vec = np.asarray(mesh.areas, dtype=dtype)
    nbl_idx = np.concatenate(
        [site_flat[b_edges[:, 0]], site_flat[b_edges[:, 1]]]
    ).astype(np.int32)
    nbl_col = np.tile(np.arange(len(b_ix), dtype=np.int32), 2)
    nbl_vals = np.concatenate(
        [b_lengths / (2 * areas_vec[b_edges[:, 0]]),
         b_lengths / (2 * areas_vec[b_edges[:, 1]])]
    ).astype(dtype)

    ops = StencilOperators(
        valid=valid, area=area, inv_area=inv_area,
        site_x=site_x, site_y=site_y,
        edge_valid=edge_valid, w=w, w_m=w_m, dual=dual, inv_len=inv_len,
        ec_x=ec_x, ec_y=ec_y,
        sym_diag=sym_diag, counts=counts, fixed_mask=fixed_mask,
        edge_dirs=edge_dirs,
        nbl_idx=nbl_idx, nbl_col=nbl_col, nbl_vals=nbl_vals,
    )
    return ops, maps
