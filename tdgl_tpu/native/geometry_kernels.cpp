// Native geometry kernels for the host-side runtime.
//
// The polygon boolean operations (Greiner-Hormann, device/clipping.py) need
// all pairwise proper intersections between two polygon edge sets — an
// O(n*m) loop that dominates Polygon.union/intersection/difference for
// finely-sampled device outlines. This C++ kernel computes them in one pass;
// degenerate configurations (collinear overlap, endpoint grazing) are
// reported so the caller can perturb and retry, matching the Python
// implementation's semantics exactly.
//
// Also provides batched point-in-polygon and point-to-polygon distance,
// used by meshing and containment queries.
//
// Built as a plain shared library; bound via ctypes (no pybind11).

#include <cmath>
#include <cstdint>
#include <cstddef>

extern "C" {

// Result codes
static const int OK = 0;
static const int DEGENERATE = 1;
static const int OVERFLOWED = 2;

// Find all proper intersections between subject edges (closed ring of n
// points) and clipper edges (closed ring of m points).
//
// Outputs (preallocated, capacity `cap`): subject edge index, clipper edge
// index, parametric positions t (on subject edge) and u (on clipper edge).
// Returns OK, DEGENERATE (caller should perturb + retry), or OVERFLOWED.
int find_intersections(
    const double* subject, int64_t n,
    const double* clipper, int64_t m,
    double eps,
    int64_t* out_si, int64_t* out_ci,
    double* out_t, double* out_u,
    int64_t cap, int64_t* out_count)
{
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
        const double p1x = subject[2 * i];
        const double p1y = subject[2 * i + 1];
        const int64_t i2 = (i + 1 == n) ? 0 : i + 1;
        const double rx = subject[2 * i2] - p1x;
        const double ry = subject[2 * i2 + 1] - p1y;
        for (int64_t j = 0; j < m; ++j) {
            const double q1x = clipper[2 * j];
            const double q1y = clipper[2 * j + 1];
            const int64_t j2 = (j + 1 == m) ? 0 : j + 1;
            const double sx = clipper[2 * j2] - q1x;
            const double sy = clipper[2 * j2 + 1] - q1y;

            const double denom = rx * sy - ry * sx;
            const double qpx = q1x - p1x;
            const double qpy = q1y - p1y;
            double scale = std::fabs(rx);
            if (std::fabs(ry) > scale) scale = std::fabs(ry);
            if (std::fabs(sx) > scale) scale = std::fabs(sx);
            if (std::fabs(sy) > scale) scale = std::fabs(sy);
            if (scale < 1e-300) scale = 1e-300;
            const double tol = eps * scale * scale;

            if (std::fabs(denom) < tol) {
                // Parallel: degenerate only if collinear AND overlapping.
                const double cross = qpx * ry - qpy * rx;
                if (std::fabs(cross) < tol) {
                    const double rr = rx * rx + ry * ry;
                    if (rr > 0) {
                        const double t0 = (qpx * rx + qpy * ry) / rr;
                        const double t1 = t0 + (sx * rx + sy * ry) / rr;
                        const double lo = t0 < t1 ? t0 : t1;
                        const double hi = t0 < t1 ? t1 : t0;
                        if (hi > eps && lo < 1.0 - eps) return DEGENERATE;
                    }
                }
                continue;
            }
            const double t = (qpx * sy - qpy * sx) / denom;
            const double u = (qpx * ry - qpy * rx) / denom;
            // Endpoint grazing: an intersection parametrically at a vertex.
            const bool t_end = (t > -eps && t < eps) || (t > 1 - eps && t < 1 + eps);
            const bool u_end = (u > -eps && u < eps) || (u > 1 - eps && u < 1 + eps);
            if (t_end || u_end) {
                if (t > -eps && t < 1 + eps && u > -eps && u < 1 + eps) {
                    return DEGENERATE;
                }
                continue;
            }
            if (t > 0.0 && t < 1.0 && u > 0.0 && u < 1.0) {
                if (count >= cap) return OVERFLOWED;
                out_si[count] = i;
                out_ci[count] = j;
                out_t[count] = t;
                out_u[count] = u;
                ++count;
            }
        }
    }
    *out_count = count;
    return OK;
}

// Is the ring simple (no proper self-intersections)? Adjacent edges (sharing
// a vertex, including the wrap) are skipped, matching the Python check in
// device/polygon.py.
int is_simple_polygon(const double* poly, int64_t n, double tol)
{
    for (int64_t i = 0; i < n; ++i) {
        const double p1x = poly[2 * i], p1y = poly[2 * i + 1];
        const int64_t i2 = (i + 1 == n) ? 0 : i + 1;
        const double rx = poly[2 * i2] - p1x;
        const double ry = poly[2 * i2 + 1] - p1y;
        for (int64_t j = i + 2; j < n; ++j) {
            if (i == 0 && j == n - 1) continue;  // adjacent through the wrap
            const double q1x = poly[2 * j], q1y = poly[2 * j + 1];
            const int64_t j2 = (j + 1 == n) ? 0 : j + 1;
            const double sx = poly[2 * j2] - q1x;
            const double sy = poly[2 * j2 + 1] - q1y;
            const double denom = rx * sy - ry * sx;
            if (std::fabs(denom) < 1e-300) continue;
            const double qpx = q1x - p1x, qpy = q1y - p1y;
            const double t = (qpx * sy - qpy * sx) / denom;
            const double u = (qpx * ry - qpy * rx) / denom;
            if (t > tol && t < 1.0 - tol && u > tol && u < 1.0 - tol) {
                return 0;
            }
        }
    }
    return 1;
}

// Even-odd point-in-polygon for a batch of points. The crossing test is
// the one of matplotlib's Path.contains_points (an edge straddles the ray
// when exactly one endpoint has y >= the point's y), so points that sit
// exactly on the boundary are classified the same way.
void points_in_polygon(
    const double* points, int64_t n_points,
    const double* poly, int64_t n_poly,
    uint8_t* out_inside)
{
    for (int64_t p = 0; p < n_points; ++p) {
        const double x = points[2 * p];
        const double y = points[2 * p + 1];
        bool inside = false;
        for (int64_t k = 0; k < n_poly; ++k) {
            const int64_t m = (k + 1 == n_poly) ? 0 : k + 1;
            const double x0 = poly[2 * k], y0 = poly[2 * k + 1];
            const double x1 = poly[2 * m], y1 = poly[2 * m + 1];
            const bool above0 = y0 >= y;
            const bool above1 = y1 >= y;
            if (above0 != above1 &&
                (((y1 - y) * (x0 - x1) >= (x1 - x) * (y0 - y1)) == above1)) {
                inside = !inside;
            }
        }
        out_inside[p] = inside ? 1 : 0;
    }
}

// Exact unsigned distance from each point to a polygon boundary.
void distance_to_polygon(
    const double* points, int64_t n_points,
    const double* poly, int64_t n_poly,
    double* out_dist)
{
    for (int64_t p = 0; p < n_points; ++p) {
        const double x = points[2 * p];
        const double y = points[2 * p + 1];
        double best = 1e300;
        for (int64_t i = 0, j = n_poly - 1; i < n_poly; j = i++) {
            const double ax = poly[2 * j], ay = poly[2 * j + 1];
            const double bx = poly[2 * i], by = poly[2 * i + 1];
            const double abx = bx - ax, aby = by - ay;
            const double ab2 = abx * abx + aby * aby;
            double t = 0.0;
            if (ab2 > 1e-300) {
                t = ((x - ax) * abx + (y - ay) * aby) / ab2;
                if (t < 0.0) t = 0.0;
                if (t > 1.0) t = 1.0;
            }
            const double dx = x - (ax + t * abx);
            const double dy = y - (ay + t * aby);
            const double d2 = dx * dx + dy * dy;
            if (d2 < best) best = d2;
        }
        out_dist[p] = std::sqrt(best);
    }
}

}  // extern "C"
