"""Structured hexagonal-lattice meshing for the stencil backend.

The unstructured mesher (:mod:`tdgl_tpu.device.meshing`) produces quality
Delaunay meshes, but the resulting finite-volume operators require gathers.
This module meshes
polygons with a *perfect triangular lattice* clipped to the film:

* Sites live at axial-coordinate lattice points ``(r, c)``:
  ``x = (c + r/2) h``, ``y = r (sqrt(3)/2) h`` — every interior site has the
  same six neighbors ``(r, c±1), (r±1, c), (r+1, c-1), (r-1, c+1)``, so every
  mesh operator becomes a 6-point stencil (array shifts, no gathers).
* The film boundary is a lattice staircase: sites outside the polygon are
  masked off. The finite-volume scheme remains exact on the clipped Voronoi
  cells — only the boundary geometry is approximated at O(h), the same order
  as any boundary-conforming mesh.
* The triangulation is produced directly from the lattice (two triangle
  classes per cell); no Delaunay call is needed and no sliver can exist.

The result is a perfectly ordinary :class:`tdgl_tpu.fv.mesh.Mesh` (used by
all post-processing), plus a :class:`HexGrid` mapping sites/edges onto a
dense ``(rows, cols)`` grid for the stencil solver.

The reference has no analog (it always meshes with ``triangle``,
``tdgl/device/meshing.py:15-123``); this is this package's own redesign of
the compute path's data layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..geometry import ensure_unique, points_in_polygon, polygon_area

# Axial neighbor offsets (dr, dc) of the three canonical ("positive") edge
# classes. Every lattice edge belongs to exactly one site's positive set and
# always points from a lower to a higher row-major flat index.
EDGE_OFFSETS = ((0, 1), (1, 0), (1, -1))  # E, N, NW


@dataclass(frozen=True)
class HexGrid:
    """Mapping between a lattice-clipped mesh and its dense grid layout.

    Attributes:
        rows, cols: Grid dimensions (axial coordinates).
        spacing: Lattice constant ``h`` (same units as the mesh sites).
        origin: ``(x0, y0)`` position of grid node ``(0, 0)``.
        site_rc: ``(n_sites, 2)`` int — (row, col) of each mesh site.
        grid_site: ``(rows, cols)`` int — mesh site index at each grid node,
            or -1 where the node is outside the film.
        edge_krc: ``(n_edges, 3)`` int — (class, row, col) of each mesh edge,
            where row/col index the edge's *origin* site and class indexes
            :data:`EDGE_OFFSETS`.
    """

    rows: int
    cols: int
    spacing: float
    origin: Tuple[float, float]
    site_rc: np.ndarray
    grid_site: np.ndarray
    edge_krc: Optional[np.ndarray] = None

    @property
    def valid_mask(self) -> np.ndarray:
        """(rows, cols) bool — grid nodes holding real mesh sites."""
        return self.grid_site >= 0

    def with_edges(self, edges: np.ndarray) -> "HexGrid":
        """Return a copy with ``edge_krc`` computed for canonical ``edges``.

        ``edges`` are (E, 2) site-index pairs with ``edges[:, 0] <
        edges[:, 1]`` (the canonical order of
        :class:`tdgl_tpu.fv.edge_mesh.EdgeMesh`). Because every positive
        offset increases the row-major flat index, each canonical edge is the
        positive edge of its first site.
        """
        rc0 = self.site_rc[edges[:, 0]]
        rc1 = self.site_rc[edges[:, 1]]
        d = rc1 - rc0
        klass = np.full(len(edges), -1, dtype=np.int64)
        for k, (dr, dc) in enumerate(EDGE_OFFSETS):
            klass[(d[:, 0] == dr) & (d[:, 1] == dc)] = k
        if (klass < 0).any():
            raise ValueError(
                "edges do not all follow the hex-lattice offsets; the mesh "
                "is not grid-structured"
            )
        edge_krc = np.column_stack([klass, rc0[:, 0], rc0[:, 1]])
        return HexGrid(
            rows=self.rows, cols=self.cols, spacing=self.spacing,
            origin=self.origin, site_rc=self.site_rc,
            grid_site=self.grid_site, edge_krc=edge_krc,
        )


def generate_structured_mesh(
    poly_coords: np.ndarray,
    hole_coords: Optional[List[np.ndarray]] = None,
    min_points: Optional[int] = None,
    max_edge_length: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray, HexGrid]:
    """Mesh a polygon (with holes) on a clipped triangular lattice.

    Args:
        poly_coords: ``(n, 2)`` film polygon vertices.
        hole_coords: Optional hole-boundary vertex arrays.
        min_points: Minimum number of mesh sites (sets the spacing).
        max_edge_length: Lattice constant upper bound.

    Returns:
        ``(sites, elements, grid)`` — the mesh sites/triangles and the
        :class:`HexGrid` layout (without edge mapping; attach it with
        :meth:`HexGrid.with_edges` once the edge mesh exists).
    """
    film = ensure_unique(np.asarray(poly_coords, dtype=float))
    if polygon_area(film) < 0:
        film = film[::-1]
    holes = [ensure_unique(np.asarray(c, dtype=float))
             for c in (hole_coords or [])]
    area = abs(polygon_area(film)) - sum(abs(polygon_area(h)) for h in holes)

    # Site density of a triangular lattice: area per site = (sqrt(3)/2) h^2.
    if min_points:
        h = float(np.sqrt(2 * area / (np.sqrt(3) * min_points)))
        if max_edge_length and max_edge_length > 0:
            h = min(h, float(max_edge_length))
    elif max_edge_length and max_edge_length > 0:
        h = float(max_edge_length)
    else:
        h = float(max(np.ptp(film[:, 0]), np.ptp(film[:, 1]))) / 32

    for _ in range(8):
        sites, elements, grid = _lattice_mesh(film, holes, h)
        if not min_points or len(sites) >= min_points:
            break
        # Undershoot (holes/clipping): shrink h toward the target count.
        h *= max(0.5, 0.97 * np.sqrt(len(sites) / float(min_points)))
    return sites, elements, grid


def _lattice_mesh(
    film: np.ndarray, holes: List[np.ndarray], h: float
) -> Tuple[np.ndarray, np.ndarray, HexGrid]:
    dy = h * np.sqrt(3) / 2
    xmin, ymin = film.min(axis=0)
    xmax, ymax = film.max(axis=0)
    rows = int(np.ceil((ymax - ymin) / dy)) + 3
    # Axial shear: x = (c + r/2) h, so the column range must cover the
    # sheared extent.
    shear = rows * 0.5 * h
    cols = int(np.ceil((xmax - xmin + shear) / h)) + 3
    origin = (xmin - shear - h, ymin - dy)

    r = np.arange(rows)
    c = np.arange(cols)
    cc, rr = np.meshgrid(c, r)
    x = origin[0] + (cc + 0.5 * rr) * h
    y = origin[1] + rr * dy
    pts = np.column_stack([x.ravel(), y.ravel()])

    inside = points_in_polygon(pts, film)
    for hole in holes:
        inside &= ~points_in_polygon(pts, hole)
    inside = inside.reshape(rows, cols)

    flat = np.arange(rows * cols).reshape(rows, cols)

    def lattice_triangles(mask):
        """Triangles per lattice cell: {(r,c),(r,c+1),(r+1,c)} and
        {(r,c+1),(r+1,c),(r+1,c+1)} — valid iff all vertices are inside."""
        a = flat[:-1, :-1]
        b = flat[:-1, 1:]
        d = flat[1:, :-1]
        e = flat[1:, 1:]
        va = mask[:-1, :-1]
        vb = mask[:-1, 1:]
        vd = mask[1:, :-1]
        ve = mask[1:, 1:]
        t1 = np.column_stack([x.ravel() for x in (a, b, d)])[
            (va & vb & vd).ravel()
        ]
        # (b, e, d) keeps the triangle counter-clockwise.
        t2 = np.column_stack([x.ravel() for x in (b, e, d)])[
            (vb & vd & ve).ravel()
        ]
        return np.concatenate([t1, t2], axis=0)

    # Clean the clipped lattice: drop "pinch" sites whose incident triangles
    # form more than one fan (they break the Voronoi dual: a single site
    # with two fans joined only at the vertex has no simple Voronoi cell).
    # A site with E incident edges and T incident triangles forms a single
    # fan iff E - T <= 1 (0 for interior sites, 1 for boundary sites).
    n = rows * cols
    for _ in range(50):
        tris = lattice_triangles(inside)
        if len(tris) == 0:
            raise ValueError(
                "Structured meshing produced no triangles; the lattice "
                "spacing is too coarse for this geometry."
            )
        n_tri = np.bincount(tris.ravel(), minlength=n)
        edges = np.concatenate(
            [tris[:, (0, 1)], tris[:, (1, 2)], tris[:, (2, 0)]]
        )
        edges = np.unique(np.sort(edges, axis=1), axis=0)
        n_edge = np.bincount(edges.ravel(), minlength=n)
        flat_inside = inside.ravel()
        bad = flat_inside & ((n_edge - n_tri) >= 2)
        # Also drop sites with no triangles (isolated points / spurs).
        bad |= flat_inside & (n_tri == 0)
        if not bad.any():
            break
        inside = (flat_inside & ~bad).reshape(rows, cols)
    else:
        raise ValueError("Structured meshing failed to remove pinch sites.")

    # Keep the largest connected component so the mesh is a single film.
    used = np.zeros(n, dtype=bool)
    used[tris.ravel()] = True
    comp = _largest_component(tris, used, n)
    tris = tris[comp[tris[:, 0]]]
    used = np.zeros(n, dtype=bool)
    used[tris.ravel()] = True

    site_of_flat = -np.ones(rows * cols, dtype=np.int64)
    flat_used = np.flatnonzero(used)
    site_of_flat[flat_used] = np.arange(len(flat_used))
    sites = pts[flat_used]
    elements = site_of_flat[tris]

    site_rc = np.column_stack([flat_used // cols, flat_used % cols])
    grid = HexGrid(
        rows=rows, cols=cols, spacing=float(h),
        origin=(float(origin[0]), float(origin[1])),
        site_rc=site_rc,
        grid_site=site_of_flat.reshape(rows, cols),
    )
    return sites, elements, grid


def _largest_component(
    tris: np.ndarray, used: np.ndarray, n: int
) -> np.ndarray:
    """Boolean mask over flat indices: member of the largest triangle-
    connected component."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    rows = np.concatenate([tris[:, 0], tris[:, 1], tris[:, 2]])
    cols = np.concatenate([tris[:, 1], tris[:, 2], tris[:, 0]])
    adj = sp.csr_array(
        (np.ones(len(rows), dtype=np.int8), (rows, cols)), shape=(n, n)
    )
    _, labels = connected_components(adj, directed=False)
    idx = np.flatnonzero(used)
    vals, counts = np.unique(labels[idx], return_counts=True)
    big = vals[np.argmax(counts)]
    mask = np.zeros(n, dtype=bool)
    mask[idx] = labels[idx] == big
    return mask
