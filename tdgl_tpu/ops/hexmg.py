"""Deep smoothed-aggregation multigrid for the stencil (hex-grid) backend.

Replaces the two-level block AMG: a full geometric-algebraic hierarchy built
by 2x2 piecewise-constant aggregation with **smoothed prolongation**
``P = (I - omega D^+ A) P0``. Key structural fact exploited here: Galerkin
coarsening with 2x2 PWC aggregation on the axial hex lattice preserves
locality, so every level's operator is a small *offset stencil* — a static
list of (dr, dc) offsets with one dense (R_l, C_l) weight array each — and
every transfer is a reshape-sum / broadcast plus one stencil apply (for the
P-smoothing). No gathers at any level.

Measured on the 50k-site benchmark system (warm-started, tol 3e-6): CG with
this preconditioner converges in ~3 iterations vs ~18 for the two-level
block AMG — at ~9 fine-apply equivalents per V-cycle, the mu solve drops
several-fold in wall-clock.

The V-cycle runs in the solve's own dtype.

The reference solves this system with a cached sparse LU
(``tdgl/finite_volume/operators.py:296-308``); multilevel cycles are the
accelerator-resident replacement that keeps scaling past where LU dies.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Static per-instance metadata (offsets/shapes) travels as pytree aux data.


class HexMGData:
    """Multigrid hierarchy (pytree: arrays as children, layout as aux).

    Attributes:
        level_arrays: Per level ``dict(W=(K, R, C), inv_diag=(R, C))`` in
            float32; the coarsest level instead holds ``dict(Ainv=(nc,
            nc))``.
        offsets: Per level, a static tuple of (dr, dc) stencil offsets
            matching ``W``'s leading axis.
        shapes: Per level, the (R, C) grid shape.
    """

    def __init__(self, level_arrays: List[dict],
                 offsets: Tuple[Tuple[Tuple[int, int], ...], ...],
                 shapes: Tuple[Tuple[int, int], ...],
                 p_omega: Tuple[float, ...] = ()):
        self.level_arrays = level_arrays
        self.offsets = offsets
        self.shapes = shapes
        self.p_omega = p_omega  # per-level P-smoothing weight (0 = PWC)

    def tree_flatten(self):
        return (self.level_arrays,), (self.offsets, self.shapes,
                                      self.p_omega)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1], aux[2])


jax.tree_util.register_pytree_node(
    HexMGData,
    lambda d: d.tree_flatten(),
    lambda aux, ch: HexMGData.tree_unflatten(aux, ch),
)


def _pwc_P(R: int, C: int):
    import scipy.sparse as sp

    r = np.arange(R * C) // C
    c = np.arange(R * C) % C
    coarse = (r // 2) * (C // 2) + (c // 2)
    return sp.csr_array(
        (np.ones(R * C), (np.arange(R * C), coarse)),
        shape=(R * C, (R // 2) * (C // 2)),
    )


def _extract_offset_stencil(A, R: int, C: int):
    """Sparse (R*C, R*C) operator -> (offsets, W[K, R, C]) offset stencil."""
    coo = A.tocoo()
    rows, cols, vals = coo.row, coo.col, coo.data
    dr = cols // C - rows // C
    dc = cols % C - rows % C
    # Wrap-free: offsets are genuine grid displacements only if no entry
    # crosses a row boundary "the wrong way"; Galerkin products of local
    # stencils guarantee |dc| small, so col-index arithmetic is exact.
    base = 100  # offsets are O(1); shift to positive for exact decoding
    assert np.abs(dr).max() < base and np.abs(dc).max() < base
    keys = (dr.astype(np.int64) + base) * (2 * base) + (
        dc.astype(np.int64) + base
    )
    uniq = np.unique(keys)
    offsets = []
    W = np.zeros((len(uniq), R, C), dtype=np.float32)
    for i, k in enumerate(uniq):
        sel = keys == k
        d_r = int(k) // (2 * base) - base
        d_c = int(k) % (2 * base) - base
        offsets.append((d_r, d_c))
        W[i].reshape(-1)[rows[sel]] = vals[sel]
    return tuple(offsets), W


def build_hexmg(
    sten,
    maps,
    mesh,
    p_omega: float = 0.67,
    min_coarse: int = 2048,
    max_levels: int = 8,
    smooth_levels: int = 3,
) -> HexMGData:
    """Build the smoothed-aggregation hierarchy for ``A = -S``.

    Args:
        sten: Host :class:`StencilOperators`.
        maps: :class:`GridMaps`.
        mesh: The structured mesh (edge graph source).
        p_omega: Prolongation-smoothing weight in ``(I - omega D^+ A) P0``.
        min_coarse: Solve directly (dense pseudo-inverse matmul) once a
            level has at most this many grid nodes.
        smooth_levels: Smooth the prolongation only on the finest this-many
            levels; PWC below. SA stencils widen under Galerkin coarsening
            (7 -> 19 -> 43 offsets), but the widened levels live on 1/16-
            size grids, and the measured V-cycle contraction improves from
            ~0.30 (2 levels) to ~0.21 (3 levels) — and to ~0.09 with the
            Chebyshev smoother pair (see ``make_hexmg_apply``).
    """
    import scipy.sparse as sp

    Rp, Cp = maps.shape
    n_flat = Rp * Cp
    em = mesh.edge_mesh
    edges = np.asarray(em.edges, np.int64)
    wgt = np.asarray(em.dual_edge_lengths / em.edge_lengths, np.float64)
    gf = maps.site_flat
    e0, e1 = gf[edges[:, 0]], gf[edges[:, 1]]
    A = sp.csr_array(
        (np.concatenate([-wgt, -wgt, wgt, wgt]),
         (np.concatenate([e0, e1, e0, e1]),
          np.concatenate([e1, e0, e0, e1]))),
        shape=(n_flat, n_flat),
    )

    level_arrays: List[dict] = []
    offsets_all: List[Tuple[Tuple[int, int], ...]] = []
    shapes: List[Tuple[int, int]] = []
    p_omegas: List[float] = []
    R, C = Rp, Cp
    for lvl in range(max_levels):
        if R * C <= min_coarse or R % 2 or C % 2 or min(R, C) < 8:
            break
        d = A.diagonal()
        dinv = np.where(d > 1e-12, 1.0 / np.maximum(d, 1e-30), 0.0)
        offs, W = _extract_offset_stencil(A, R, C)
        # Stored in float32; the apply casts to the solve's dtype.
        level_arrays.append(dict(
            W=jnp.asarray(W),
            inv_diag=jnp.asarray(dinv.reshape(R, C).astype(np.float32)),
        ))
        offsets_all.append(offs)
        shapes.append((R, C))
        om_l = p_omega if lvl < smooth_levels else 0.0
        p_omegas.append(om_l)
        P0 = _pwc_P(R, C)
        if om_l:
            P = P0 - om_l * (sp.diags_array(dinv) @ (A @ P0))
        else:
            P = P0
        A = (P.T @ A @ P).tocsr()
        A.eliminate_zeros()
        R //= 2
        C //= 2
    # Coarsest: dense pseudo-inverse (constant null space removed exactly).
    Ad = np.asarray(A.todense())
    level_arrays.append(dict(
        Ainv=jnp.asarray(np.linalg.pinv(Ad, rcond=1e-10).astype(np.float32)),
    ))
    offsets_all.append(())
    shapes.append((R, C))
    return HexMGData(level_arrays, tuple(offsets_all), tuple(shapes),
                     p_omega=tuple(p_omegas))


def _shift_nowrap(x: jax.Array, dr: int, dc: int) -> jax.Array:
    """Zero-filled (non-wrapping) shift: result[r, c] = x[r + dr, c + dc]."""
    R, C = x.shape
    lo_r, hi_r = max(dr, 0), R + min(dr, 0)
    lo_c, hi_c = max(dc, 0), C + min(dc, 0)
    core = x[lo_r:hi_r, lo_c:hi_c]
    return jnp.pad(core, ((max(-dr, 0), max(dr, 0)),
                          (max(-dc, 0), max(dc, 0))))


def level_apply(mg: HexMGData, lvl: int, x: jax.Array) -> jax.Array:
    """Offset-stencil matvec at hierarchy level ``lvl``.

    Every level operator here is symmetric (Galerkin products of the
    symmetric fine operator), which in offset-stencil form means
    ``W_{-d}[r, c] = W_d[r - dr, c - dc]`` — the negative-offset plane is
    a zero-filled shift of the positive one. Exploit it: read only the
    canonical half of the weight planes and derive the mirrored term as
    ``y += shift_{-d}(W_d ⊙ x)``. The V-cycle is HBM-bound, so halving
    its weight reads is the dominant lever on its cost (it runs 2-3x per
    TDGL step inside MG-CG). Uses one shared zero-padded buffer + static
    slices per offset (a pad per offset bloats the graph and is
    pathologically slow on CPU).
    """
    W = mg.level_arrays[lvl]["W"].astype(x.dtype)
    offs = mg.offsets[lvl]
    R, C = x.shape
    pr = max(max(abs(dr) for dr, _ in offs), 1)
    pc = max(max(abs(dc) for _, dc in offs), 1)
    xp = jnp.pad(x, ((pr, pr), (pc, pc)))
    acc = jnp.zeros_like(x)
    idx = {o: i for i, o in enumerate(offs)}
    symmetric = all((-a, -b) in idx for (a, b) in offs)
    if not symmetric:  # pragma: no cover — SA sparsity is always paired
        for i, (dr, dc) in enumerate(offs):
            if dr == 0 and dc == 0:
                acc = acc + W[i] * x
            else:
                acc = acc + W[i] * jax.lax.slice(
                    xp, (pr + dr, pc + dc), (pr + dr + R, pc + dc + C)
                )
        return acc
    if (0, 0) in idx:
        acc = acc + W[idx[(0, 0)]] * x
    canon = [d for d in offs if d > (0, 0)]
    # One stacked pad for all mirrored products.
    prods = jnp.stack([W[idx[d]] * x for d in canon])
    pp = jnp.pad(prods, ((0, 0), (pr, pr), (pc, pc)))
    for i, (dr, dc) in enumerate(canon):
        acc = acc + W[idx[(dr, dc)]] * jax.lax.slice(
            xp, (pr + dr, pc + dc), (pr + dr + R, pc + dc + C)
        )
        # y[r, c] += W_{-d}[r, c] x[r-dr, c-dc] = (W_d ⊙ x)[r-dr, c-dc]
        acc = acc + jax.lax.slice(
            pp, (i, pr - dr, pc - dc), (i + 1, pr - dr + R, pc - dc + C)
        )[0]
    return acc


def block_sum(shape: Tuple[int, int], r: jax.Array) -> jax.Array:
    """2x2 block-sum restriction of an ``shape`` = (R, C) grid."""
    R, C = shape
    return r.reshape(R // 2, 2, C // 2, 2).sum(axis=(1, 3))


def block_broadcast(xc: jax.Array) -> jax.Array:
    """Transpose of :func:`block_sum` (2x2 broadcast)."""
    return jnp.repeat(jnp.repeat(xc, 2, axis=0), 2, axis=1)


def make_hexmg_apply(amg_omega: float, kappa: float = 1.0,
                     n_smooth: int = 1):
    """Returns the jax V-cycle apply ``(mg, r) -> z`` (in ``r``'s dtype).

    ``amg_omega`` damps the Jacobi smoother; ``kappa`` over-corrects the
    coarse-grid update (useful with unsmoothed transfers; 1.0 with SA);
    ``n_smooth`` is the number of damped-Jacobi sweeps per pre/post
    smoothing pass (V(n,n) cycles — each extra sweep costs one stencil
    apply per level but strengthens the cycle's contraction).
    """

    def smooth_P_T(mg, lvl, r):
        """P^T r = P0^T (r - omega_p A (D^+ r)) then 2x2 block sum."""
        om_p = mg.p_omega[lvl]  # static
        if om_p:
            inv_diag = mg.level_arrays[lvl]["inv_diag"].astype(r.dtype)
            r = r - jnp.asarray(om_p, r.dtype) * level_apply(
                mg, lvl, inv_diag * r)
        return block_sum(mg.shapes[lvl], r)

    def smooth_P(mg, lvl, xc):
        """P xc = (I - omega_p D^+ A) (2x2 broadcast of xc)."""
        om_p = mg.p_omega[lvl]  # static
        up = block_broadcast(xc)
        if om_p:
            inv_diag = mg.level_arrays[lvl]["inv_diag"].astype(xc.dtype)
            up = up - jnp.asarray(om_p, xc.dtype) * (
                inv_diag * level_apply(mg, lvl, up))
        return up

    # amg_omega may be a scalar (same damping every sweep) or a tuple of
    # per-sweep dampings (Chebyshev-style pairs); n_smooth defaults to the
    # tuple length.
    omegas = (tuple(amg_omega) if isinstance(amg_omega, (tuple, list))
              else (float(amg_omega),) * max(1, n_smooth))
    if isinstance(amg_omega, (tuple, list)):
        n_sweeps = len(omegas)
    else:
        n_sweeps = max(1, n_smooth)

    def cycle(mg: HexMGData, lvl: int, b: jax.Array) -> jax.Array:
        lev = mg.level_arrays[lvl]
        if "Ainv" in lev:
            R, C = mg.shapes[lvl]
            # HIGHEST: an f32 matmul may otherwise run in TF32 on the GPU.
            return jnp.matmul(lev["Ainv"].astype(b.dtype), b.reshape(-1),
                              precision=jax.lax.Precision.HIGHEST
                              ).reshape(R, C)
        inv_diag = lev["inv_diag"].astype(b.dtype)
        x = jnp.asarray(omegas[0], b.dtype) * inv_diag * b
        for i in range(1, n_sweeps):
            x = x + jnp.asarray(omegas[i], b.dtype) * inv_diag * (
                b - level_apply(mg, lvl, x))
        r = b - level_apply(mg, lvl, x)
        xc = cycle(mg, lvl + 1, smooth_P_T(mg, lvl, r))
        x = x + jnp.asarray(kappa, b.dtype) * smooth_P(mg, lvl, xc)
        for i in range(n_sweeps):
            r = b - level_apply(mg, lvl, x)
            x = x + (jnp.asarray(omegas[n_sweeps - 1 - i], b.dtype)
                      * inv_diag * r)
        return x

    def apply_mg(mg: HexMGData, r: jax.Array) -> jax.Array:
        return cycle(mg, 0, r)

    return apply_mg
