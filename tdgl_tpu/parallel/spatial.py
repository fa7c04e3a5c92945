"""Single-problem multi-device execution: shard one structured solve's grid
across devices.

The sweep axis (:mod:`tdgl_tpu.parallel.sweep`) is the natural use of extra
devices when many independent solves are wanted; THIS module spans devices
with **one** problem — for meshes too large for a single device's memory,
or to shorten wall-clock on one big solve.

Design: the stencil backend's state is dense ``(Rp, Cp)`` grid arrays and
every operator is a 6-point stencil (`jnp.roll` + elementwise math), so the
natural decomposition is **SPMD over grid rows**: place every
grid-shaped array with a ``NamedSharding`` that splits the row axis across
a 1D ``jax.sharding.Mesh``, and run the *unchanged* compiled chunk program.
XLA's SPMD partitioner turns each roll into a halo exchange
(collective-permute) and each reduction into an all-reduce —
hand-written ppermute halo code would express exactly the same
communication, with none of the compiler's fusion.

The multigrid hierarchy shards the same way level by level until a level is
too small to split usefully; coarse levels and the dense coarsest inverse
replicate (they are tiny). FFT screening spectra replicate.

There is no reference analog (the reference is single-process,
``SURVEY.md`` §2.8); this is new capability.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["spatial_device_mesh", "shard_solver_spatially", "spatial_spec"]

_AXIS = "rows"


def spatial_device_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1D device mesh over ``devices`` (default: all local devices)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (_AXIS,))


def spatial_spec(shape, Rp: int, Cp: int, n_dev: int):
    """PartitionSpec sharding the grid-row axis of ``shape`` (an array
    shape whose dims contain adjacent ``(Rp, Cp)``), or full replication
    when no (sufficiently large) grid block is present."""
    shape = tuple(shape)
    for i in range(len(shape) - 1):
        if shape[i] == Rp and shape[i + 1] == Cp:
            # Only shard when every device gets at least one 8-row tile.
            if Rp >= 8 * n_dev:
                spec = [None] * len(shape)
                spec[i] = _AXIS
                return P(*spec)
    return P()


def shard_solver_spatially(solver, mesh: Optional[Mesh] = None, *,
                           allow_replicated: bool = False):
    """Re-place a structured :class:`TDGLSolver`'s device operands so its
    compiled chunk executes SPMD across ``mesh`` (grid rows split over
    devices; everything else replicated).

    Call once after constructing the solver and before the first chunk;
    then shard each state with the returned function:

    ```python
    solver = TDGLSolver(device, options, ...)
    shard = shard_solver_spatially(solver)
    state = shard(solver._initial_state())
    state, outputs, exported = solver.chunk_fn(state)
    ```

    Raises:
        ValueError: when the grid is too small to give every device at
            least one 8-row tile, so *nothing* would shard — the solve
            would silently replicate on every device (n_dev x the memory,
            zero speedup). Pass ``allow_replicated=True`` to accept the
            replicated placement anyway (e.g. for testing the placement
            machinery on tiny problems).

    Returns:
        ``shard(tree)`` — places any solver-state pytree with the same
        row-sharding policy.
    """
    if not getattr(solver, "structured", False):
        raise ValueError(
            "Spatial sharding requires the structured (stencil) backend:"
            " mesh with device.make_mesh(structured=True)."
        )
    if mesh is None:
        mesh = spatial_device_mesh()
    n_dev = int(np.prod(list(mesh.shape.values())))
    import dataclasses

    cfg_updates = {}
    Rp, Cp = solver.maps.shape
    if n_dev > 1 and spatial_spec((Rp, Cp), Rp, Cp, n_dev) == P():
        msg = (
            f"Grid ({Rp}, {Cp}) is too small to shard over {n_dev} devices:"
            f" row-sharding needs Rp >= 8 * n_dev = {8 * n_dev} so every"
            " device gets at least one 8-row tile. Every array would be"
            " REPLICATED (n_dev x the memory, no speedup). Use a finer mesh,"
            " fewer devices, or pass allow_replicated=True to proceed"
            " anyway."
        )
        if not allow_replicated:
            raise ValueError(msg)
        import logging

        logging.getLogger(__name__).warning(msg)

    def place(tree):
        def put(leaf):
            arr = np.asarray(leaf) if not hasattr(leaf, "shape") else leaf
            spec = spatial_spec(arr.shape, Rp, Cp, n_dev)
            return jax.device_put(leaf, NamedSharding(mesh, spec))

        return jax.tree_util.tree_map(put, tree)

    # Operator tables: grid-shaped fields shard, small tables replicate.
    solver.sten = place(solver.sten)
    # Multigrid hierarchy: each level's (R_l, C_l) arrays shard while the
    # level still has >= 8 rows per device; coarse levels replicate.
    if solver.amg is not None:
        from ..ops.hexmg import HexMGData

        level_arrays = []
        for lvl, arrays in enumerate(solver.amg.level_arrays):
            R_l, C_l = solver.amg.shapes[lvl]
            placed = {}
            for name, arr in arrays.items():
                spec = spatial_spec(arr.shape, R_l, C_l, n_dev)
                placed[name] = jax.device_put(arr,
                                              NamedSharding(mesh, spec))
            level_arrays.append(placed)
        solver.amg = HexMGData(level_arrays, solver.amg.offsets,
                               solver.amg.shapes, solver.amg.p_omega)
    # Screening: weights shard; the FFT convolution runs as per-device
    # pencil FFTs with COLUMN-SHARDED kernel spectra (parallel/fft_sharded)
    # when the grid pencil-decomposes over this mesh, so per-device FFT
    # work and spectrum memory drop ~1/n_dev. Otherwise the spectra
    # replicate and the partitioner all-gathers (correct, round-3
    # behavior).
    weights, fft_data = solver._screening_weights
    weights = place(weights)
    if fft_data is not None:
        from .fft_sharded import (
            make_sharded_fft_screening,
            pad_fft_data_for_sharding,
        )

        eval_fn = make_sharded_fft_screening(mesh, Rp, Cp)
        if eval_fn is not None:
            fft_data = pad_fft_data_for_sharding(fft_data, n_dev, mesh)
            cfg_updates["screening_eval_fn"] = eval_fn
        else:
            import logging

            logging.getLogger(__name__).warning(
                "Grid rows (%d) do not pencil-decompose over %d devices;"
                " FFT screening spectra will replicate.", Rp, n_dev,
            )
            fft_data = jax.device_put(fft_data, NamedSharding(mesh, P()))
    solver._screening_weights = (weights, fft_data)
    if cfg_updates:
        from ..solver.grid_step import make_grid_chunk_fn

        solver.cfg = dataclasses.replace(solver.cfg, **cfg_updates)
        solver._raw_chunk_fn = make_grid_chunk_fn(solver.cfg,
                                                  solver.chunk_size)
        solver.chunk_fn = lambda state: solver._raw_chunk_fn(
            solver.sten, solver._screening_weights, solver.amg, state
        )
    return place
