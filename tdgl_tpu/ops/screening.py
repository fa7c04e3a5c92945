"""Induced-vector-potential kernel for magnetic screening.

The reference computes ``A_induced[e] = sum_s J[s] a_s / |r_e - r_s|`` with a
Numba ``prange`` CPU loop or a raw CuPy kernel
(``tdgl/solver/screening.py:12-75``). This is the dense O(E x S) hot spot of
screened simulations.

Here the whole kernel is one elementwise broadcast and one matrix product,

    invD = rsqrt(sum_c (e_c - s_c)^2)   (broadcast over an edge block)
    A    = invD @ (J * a)               (matmul)

blocked over edges so the (block x S) intermediate stays bounded. The
distance is computed by direct differences (not the Gram-matrix identity)
because ``|r|^2 - 2 e.s`` cancellation destroys float32 precision when the
device extent is much larger than the mesh spacing.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def induced_vector_potential(
    edge_centers: jax.Array,
    sites: jax.Array,
    J_weighted: jax.Array,
    block_size: int = 256,
) -> jax.Array:
    """Compute ``A[e, c] = sum_s J_weighted[s, c] / |r_e - r_s|``.

    Args:
        edge_centers: ``(E, 2)`` edge-center positions.
        sites: ``(S, 2)`` site positions. Must all differ from every edge
            center (guaranteed on a triangular mesh: edge centers are never
            sites).
        J_weighted: ``(S, 2)`` current density times site area (and any
            physical prefactor).
        block_size: Edge-block size; bounds the (block, S) intermediate.

    Returns:
        ``(E, 2)`` induced vector potential.
    """
    E = edge_centers.shape[0]
    dtype = J_weighted.dtype
    edge_centers = edge_centers.astype(dtype)
    sites = sites.astype(dtype)
    n_blocks = -(-E // block_size)
    pad = n_blocks * block_size - E
    ec = jnp.pad(edge_centers, ((0, pad), (0, 0)))
    ec_blocks = ec.reshape(n_blocks, block_size, 2)

    def block_fn(ec_block):
        dx = ec_block[:, 0][:, None] - sites[:, 0][None, :]
        dy = ec_block[:, 1][:, None] - sites[:, 1][None, :]
        d2 = dx * dx + dy * dy
        inv_d = jax.lax.rsqrt(jnp.maximum(d2, jnp.finfo(dtype).tiny))
        # HIGHEST: an f32 matmul may otherwise run in TF32 on the GPU.
        return jnp.matmul(inv_d, J_weighted,
                          precision=jax.lax.Precision.HIGHEST)  # (bs, 2)

    out = jax.lax.map(block_fn, ec_blocks)
    return out.reshape(n_blocks * block_size, 2)[:E]
