"""Geometry helper functions for constructing device polygons.

API parity with the reference ``tdgl/geometry.py:6-186`` (``box``, ``circle``,
``ellipse``, ``rotate``, ``close_curve``, ``ensure_unique``, ``path_vectors``).
Pure NumPy; runs on host, feeding the meshing pipeline.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def rotation_matrix(angle_radians: float) -> np.ndarray:
    """2D counterclockwise rotation matrix."""
    c, s = np.cos(angle_radians), np.sin(angle_radians)
    return np.array([[c, -s], [s, c]])


def rotate(coords: np.ndarray, angle_degrees: float) -> np.ndarray:
    """Rotate ``(n, 2)`` coordinates counterclockwise by ``angle_degrees``."""
    coords = np.asarray(coords)
    if coords.ndim != 2 or coords.shape[1] != 2:
        raise ValueError(f"Expected shape (n, 2), got {coords.shape}")
    return coords @ rotation_matrix(np.radians(angle_degrees)).T


def ellipse(
    a: float,
    b: float,
    points: int = 100,
    center: Tuple[float, float] = (0, 0),
    angle: float = 0,
) -> np.ndarray:
    """Vertices of an ellipse with semi-axes ``a`` and ``b``, translated to
    ``center`` and then rotated by ``angle`` degrees about the origin."""
    theta = np.linspace(0, 2 * np.pi, points, endpoint=False)
    coords = np.stack([a * np.cos(theta), b * np.sin(theta)], axis=1)
    coords = coords + np.asarray(center, dtype=float)
    if angle:
        coords = rotate(coords, angle)
    return coords


def circle(
    radius: float, points: int = 100, center: Tuple[float, float] = (0, 0)
) -> np.ndarray:
    """Vertices of a circle of a given ``radius`` centered at ``center``."""
    return ellipse(radius, radius, points=points, center=center)


def box(
    width: float,
    height: Optional[float] = None,
    points: int = 101,
    center: Tuple[float, float] = (0, 0),
    angle: float = 0,
) -> np.ndarray:
    """Vertices of a rectangle of ``width`` x ``height`` centered at ``center``,
    with approximately ``points`` total vertices distributed over the perimeter,
    rotated by ``angle`` degrees about the origin after translation."""
    width = abs(width)
    height = width if height is None else abs(height)
    perimeter = 2 * (width + height)
    nx = round(points * width / perimeter)
    ny = round(points * height / perimeter)
    w2, h2 = width / 2, height / 2
    # Traverse counterclockwise starting from the bottom-right corner.
    xs = np.concatenate([
        np.full(ny, w2),
        np.linspace(w2, -w2, nx),
        np.full(ny, -w2),
        np.linspace(-w2, w2, nx),
    ])
    ys = np.concatenate([
        np.linspace(-h2, h2, ny),
        np.full(nx, h2),
        np.linspace(h2, -h2, ny),
        np.full(nx, -h2),
    ])
    coords = np.stack([xs, ys], axis=1) + np.asarray(center, dtype=float)
    if angle:
        coords = rotate(coords, angle)
    return coords


def close_curve(points: np.ndarray) -> np.ndarray:
    """Append the first point to the end if the curve is not already closed."""
    points = np.asarray(points)
    if not np.allclose(points[0], points[-1]):
        points = np.concatenate([points, points[:1]], axis=0)
    return points


def ensure_unique(coords: np.ndarray) -> np.ndarray:
    """Remove duplicate vertices while preserving order."""
    coords = np.asarray(coords)
    _, index = np.unique(coords, return_index=True, axis=0)
    return coords[np.sort(index)]


def unit_vector(vector: np.ndarray) -> np.ndarray:
    """Normalize vectors along the last axis."""
    return vector / np.linalg.norm(vector, axis=-1, keepdims=True)


def path_vectors(path: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Edge lengths and (right-handed) unit normals for a polyline.

    Returns a shape ``(n-1,)`` array of segment lengths and a shape
    ``(n-1, 2)`` array of unit normals to each segment.
    """
    dr = np.diff(path, axis=0)
    # Normal of (dx, dy) is (dy, -dx): the cross product with +z.
    normals = np.stack([dr[:, 1], -dr[:, 0]], axis=1)
    return np.linalg.norm(dr, axis=1), unit_vector(normals)


def polygon_area(coords: np.ndarray) -> float:
    """Signed area of a polygon via the shoelace formula (positive if CCW)."""
    coords = np.asarray(coords, dtype=float)
    x, y = coords[:, 0], coords[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def polygon_centroid(coords: np.ndarray) -> np.ndarray:
    """Area centroid of a simple polygon."""
    coords = np.asarray(coords, dtype=float)
    x, y = coords[:, 0], coords[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    area = 0.5 * np.sum(cross)
    if abs(area) < 1e-300:
        return coords.mean(axis=0)
    cx = np.sum((x + xn) * cross) / (6 * area)
    cy = np.sum((y + yn) * cross) / (6 * area)
    return np.array([cx, cy])


def points_in_polygon(
    points: np.ndarray, polygon: np.ndarray, radius: float = 0.0
) -> np.ndarray:
    """Vectorized even-odd (ray casting) point-in-polygon test.

    Args:
        points: Shape ``(n, 2)`` query points.
        polygon: Shape ``(m, 2)`` polygon vertices (open or closed).
        radius: Nonzero ``radius`` dilates (positive) or erodes (negative) the
            polygon boundary: points within ``|radius|`` of the boundary are
            included/excluded accordingly (mirrors
            ``matplotlib.path.Path.contains_points(radius=...)`` usage).

    Returns:
        Boolean array of shape ``(n,)``.
    """
    points = np.atleast_2d(np.asarray(points, dtype=float))
    poly = np.asarray(polygon, dtype=float)
    if np.allclose(poly[0], poly[-1]):
        poly = poly[:-1]
    from .native import points_in_polygon_native

    inside = points_in_polygon_native(points, poly)
    if inside is None:
        inside = _points_in_polygon_numpy(points, poly)
    if radius != 0.0:
        d = distance_to_polygon(points, poly)
        if radius > 0:
            inside = inside | (d <= radius)
        else:
            inside = inside & (d > -radius)
    return inside


def _points_in_polygon_numpy(points: np.ndarray, poly: np.ndarray,
                             chunk_elements: int = 20_000_000) -> np.ndarray:
    """Even-odd ray casting with the native kernel's crossing test (that of
    matplotlib's ``Path.contains_points``), chunked so the (points x edges)
    intermediates stay bounded."""
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    inside = np.empty(len(points), dtype=bool)
    step = max(1, chunk_elements // max(1, len(poly)))
    for s in range(0, len(points), step):
        x = points[s:s + step, :1]
        y = points[s:s + step, 1:]
        above1 = y1 >= y
        crosses = (y0 >= y) != above1
        hit = ((y1 - y) * (x0 - x1) >= (x1 - x) * (y0 - y1)) == above1
        inside[s:s + step] = (
            np.count_nonzero(crosses & hit, axis=1) % 2 == 1
        )
    return inside


def distance_to_polygon(points: np.ndarray, polygon: np.ndarray,
                        chunk_elements: int = 20_000_000) -> np.ndarray:
    """Unsigned distance from each point to the polygon boundary.

    Exact point-to-segment distances; uses the native C++ kernel when
    available, else chunked NumPy broadcasting."""
    points = np.atleast_2d(np.asarray(points, dtype=float))
    poly = np.asarray(polygon, dtype=float)
    if np.allclose(poly[0], poly[-1]):
        poly = poly[:-1]
    if len(points) * len(poly) > 10_000:
        from .native import distance_to_polygon_native

        native = distance_to_polygon_native(points, poly)
        if native is not None:
            return native
    a = poly
    b = np.roll(poly, -1, axis=0)
    ab = b - a  # (m, 2)
    ab_sq = np.maximum(np.sum(ab**2, axis=1), 1e-300)  # (m,)
    m = len(poly)
    out = np.empty(len(points))
    rows = max(1, chunk_elements // max(m, 1))
    for start in range(0, len(points), rows):
        stop = min(start + rows, len(points))
        p = points[start:stop]
        ap = p[:, None, :] - a[None, :, :]  # (r, m, 2)
        t = np.clip(
            (ap[:, :, 0] * ab[None, :, 0] + ap[:, :, 1] * ab[None, :, 1])
            / ab_sq, 0.0, 1.0,
        )
        dx = ap[:, :, 0] - t * ab[None, :, 0]
        dy = ap[:, :, 1] - t * ab[None, :, 1]
        out[start:stop] = np.sqrt(np.min(dx * dx + dy * dy, axis=1))
    return out
