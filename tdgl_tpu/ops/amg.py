"""Two-level aggregation multigrid preconditioner for the mu-Poisson solve.

The reference solves the (fixed) mu-Laplacian with a cached LU factorization
(``tdgl/finite_volume/operators.py:296-308``) — exact but sequential, with
no parallel accelerator analog. Jacobi-PCG works but its iteration count
grows with mesh size and degrades badly on meshes with strong weight
contrast.

This module implements an unsmoothed-aggregation two-level preconditioner
instead.

* **Setup (host, once per mesh)**: greedy aggregation of sites into
  clusters on the Laplacian graph; the coarse Galerkin operator
  ``Ac = P^T A P`` (piecewise-constant P) is formed and **pseudo-inverted
  densely** — the coarse null space (constants) is projected out exactly.
* **Apply (device, inside CG)**: symmetric V-cycle
  ``Jacobi pre-smooth -> coarse correction -> Jacobi post-smooth``.
  The fine-level transfers are gathers/segment-sums; the coarse solve is a
  dense ``(nc, nc) @ (nc,)`` matrix-vector product.

The preconditioner is symmetric positive definite on the orthogonal
complement of the constants, which is exactly the deflated subspace CG
operates in.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class AMGData(NamedTuple):
    """Device arrays of the two-level preconditioner (a pytree).

    The damped-Jacobi weight ``omega`` deliberately is NOT a field: python
    floats in traced pytrees become 0-d device scalars, which constrained
    backends mishandle; it is threaded statically instead."""

    cluster_ids: np.ndarray   # (N,) int32 — aggregate of each site
    Ac_inv: np.ndarray        # (nc, nc) — dense pseudo-inverse of P^T A P
    inv_diag: np.ndarray      # (N,) — 1 / diag(A)


def build_amg(op, coarsening: int = 32,
              dtype=np.float32) -> AMGData:
    """Build the two-level hierarchy for the operator ``A = -S`` (the
    symmetric Neumann FV Laplacian of :mod:`tdgl_tpu.models.gtdgl`).

    Args:
        op: Host :class:`FVOperators`.
        coarsening: Target fine-to-coarse size ratio (aggregate size).
    """
    import scipy.sparse as sp

    n = len(op.areas)
    e0 = np.asarray(op.edges[:, 0], dtype=np.int64)
    e1 = np.asarray(op.edges[:, 1], dtype=np.int64)
    w = np.asarray(op.dual_edge_lengths / op.edge_lengths, dtype=np.float64)
    rows = np.concatenate([e0, e1, e0, e1])
    cols = np.concatenate([e1, e0, e0, e1])
    vals = np.concatenate([-w, -w, w, w])  # A = -S (PSD)
    A = sp.csr_array((vals, (rows, cols)), shape=(n, n))

    # Greedy aggregation by strongest available connection, BFS-ordered so
    # aggregates are contiguous patches.
    indptr, indices = A.indptr, A.indices
    cluster = -np.ones(n, dtype=np.int64)
    next_cluster = 0
    order = np.argsort(-A.diagonal())  # seed from stiff regions first
    for seed in order:
        if cluster[seed] >= 0:
            continue
        members = [seed]
        cluster[seed] = next_cluster
        frontier = [seed]
        while frontier and len(members) < coarsening:
            new_frontier = []
            for u in frontier:
                for v in indices[indptr[u]:indptr[u + 1]]:
                    if cluster[v] < 0 and len(members) < coarsening:
                        cluster[v] = next_cluster
                        members.append(v)
                        new_frontier.append(v)
            frontier = new_frontier
        next_cluster += 1
    nc = next_cluster

    # Galerkin coarse operator Ac = P^T A P with piecewise-constant P.
    P = sp.csr_array(
        (np.ones(n), (np.arange(n), cluster)), shape=(n, nc)
    )
    Ac = np.asarray((P.T @ A @ P).todense())
    # Deflate the constant null space exactly, then pseudo-invert.
    Ac_inv = np.linalg.pinv(Ac, rcond=1e-12)

    diag = np.asarray(A.diagonal())
    inv_diag = 1.0 / np.maximum(diag, 1e-300)
    return AMGData(
        cluster_ids=cluster.astype(np.int32),
        Ac_inv=Ac_inv.astype(dtype),
        inv_diag=inv_diag.astype(dtype),
    )


def make_amg_apply(amg_omega: float):
    """Returns the jax V-cycle apply ``(apply_A, amg, r) -> z``."""
    import jax
    import jax.numpy as jnp

    def apply_amg(apply_A, amg, r):
        rdtype = r.dtype
        inv_diag = amg.inv_diag.astype(rdtype)
        nc = amg.Ac_inv.shape[0]
        # Pre-smooth.
        x = amg_omega * inv_diag * r
        # Coarse correction.
        r2 = r - apply_A(x)
        rc = jnp.zeros(nc, rdtype).at[amg.cluster_ids].add(r2)
        # HIGHEST: an f32 matmul may otherwise run in TF32 on the GPU.
        xc = jnp.matmul(amg.Ac_inv.astype(rdtype), rc,
                        precision=jax.lax.Precision.HIGHEST)
        x = x + xc[amg.cluster_ids]
        # Post-smooth (symmetric cycle).
        r3 = r - apply_A(x)
        x = x + amg_omega * inv_diag * r3
        return x

    return apply_amg
