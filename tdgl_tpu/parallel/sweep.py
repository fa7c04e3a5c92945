"""Multi-device batched parameter sweeps.

The reference has no parallel execution beyond a single GPU (SURVEY 2.8): a
physicist runs IV curves or field sweeps as many sequential solves. Here the
whole compiled TDGL step is ``vmap``-ed over a batch axis of physical
parameters (bias current and/or applied-field scale) and sharded across a
``jax.sharding.Mesh`` of devices, so an N-point sweep costs one solve of
wall-clock on N devices. XLA inserts any collectives; there is no
hand-written communication.

All inner control flow (dt retries, screening fixed point, CG) is
vmap-safe: every ``while_loop`` body gates its updates per batch member.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..device.device import Device
from ..utils.jaxio import to_numpy, tree_to_numpy
from ..solver.options import SolverOptions
from ..solver.solver import TDGLSolver
from ..solver.step import StepOutputs


@dataclass
class SweepResult:
    """Results of a batched sweep.

    Attributes:
        values: The swept parameter values, shape ``(B,)``.
        psi: Final order parameters, shape ``(B, N)``.
        mu: Final scalar potentials, shape ``(B, N)``.
        supercurrent / normal_current: Final edge currents, ``(B, E)``.
        dynamics_dt: Per-step dt, shape ``(B, T)`` (zero-padded).
        dynamics_mu: Probe-point potentials, ``(B, P, T)``.
        dynamics_theta: Probe-point phases, ``(B, P, T)``.
        steps: Number of steps each member took, shape ``(B,)``.
    """

    values: np.ndarray
    psi: np.ndarray
    mu: np.ndarray
    supercurrent: np.ndarray
    normal_current: np.ndarray
    dynamics_dt: np.ndarray
    dynamics_mu: np.ndarray
    dynamics_theta: np.ndarray
    steps: np.ndarray
    failed: np.ndarray = None  # (B,) bool — per-member failure flags
    times: np.ndarray = None   # (B,) final simulation times
    solutions: Optional[List] = None  # per-member Solutions (output_dir=)

    def mean_voltages(self, i: int = 0, j: int = 1,
                      tmin: float = 0.0) -> np.ndarray:
        """dt-weighted mean voltage between probe points i and j for each
        sweep member (the IV-curve ordinate)."""
        out = np.zeros(len(self.values))
        for b in range(len(self.values)):
            dt = self.dynamics_dt[b]
            mask = dt > 0
            times = np.cumsum(dt)
            mask &= times >= tmin
            v = self.dynamics_mu[b, i] - self.dynamics_mu[b, j]
            out[b] = np.average(v[mask], weights=dt[mask]) if mask.any() else 0.0
        return out


def _scale_applied(applied, s: float):
    """The effective applied-vector-potential input of a field-sweep
    member: ``s * applied``. Numbers and Parameters multiply directly
    (operator algebra); plain callables get a cloudpickle-able closure."""
    try:
        return applied * s
    except TypeError:
        return lambda *args, _f=applied, _s=s, **kw: (
            _s * np.asarray(_f(*args, **kw))
        )


def _write_member_solutions(
    output_dir: str, solver, device, options, exported, scales, steps,
    dyn_dt, dyn_mu, dyn_theta, applied_vector_potential, terminal_currents,
    disorder_epsilon, field_sweep: bool, dynamic_currents: bool,
):
    """Write each sweep member's final state as a standalone output file in
    the standard schema and return the corresponding Solutions."""
    import os

    import h5py

    from ..solution.solution import Solution

    os.makedirs(output_dir, exist_ok=True)
    solutions = []
    for b in range(len(scales)):
        member = {k: np.asarray(v[b]) for k, v in exported.items()}
        data = solver._state_to_arrays(member)
        # The standalone file must be self-contained: include the (possibly
        # fixed) applied potential and disorder, converted off the grid.
        if "applied_vector_potential" not in data:
            ap = member["applied_vector_potential"]
            data["applied_vector_potential"] = (
                solver.maps.grid_to_edge(ap) if solver.structured else ap
            )
        if "epsilon" not in data:
            eps = member["epsilon"]
            data["epsilon"] = (
                solver.maps.grid_to_site(eps) if solver.structured else eps
            )
        n_b = int(steps[b])
        diag = member["diagnostics"]
        # Serial-rename on collision (as DataHandler does) rather than
        # raising AFTER the whole sweep was solved.
        serial = None
        while True:
            tag = f"-{serial}" if serial is not None else ""
            path = os.path.join(output_dir, f"member_{b:03d}{tag}.h5")
            if not os.path.exists(path):
                break
            serial = 1 if serial is None else serial + 1
        if serial is not None:
            import logging

            logging.getLogger(__name__).warning(
                "Member output file already exists; renamed to %s.", path
            )
        with h5py.File(path, "x") as f:
            solver.mesh.to_hdf5(f.create_group("mesh"))
            grp = f.create_group("data").create_group("0")
            grp.attrs["step"] = n_b
            grp.attrs["time"] = float(diag[0])
            grp.attrs["dt"] = float(dyn_dt[b, n_b - 1]) if n_b else 0.0
            for key, value in data.items():
                grp[key] = np.asarray(value)
            rs = grp.create_group("running_state")
            rs["dt"] = dyn_dt[b, :n_b]
            if dyn_mu.shape[1]:  # probe points present
                rs["mu"] = np.squeeze(dyn_mu[b, :, :n_b])
                rs["theta"] = np.squeeze(dyn_theta[b, :, :n_b])
        s = float(scales[b])
        if field_sweep:
            A_b = _scale_applied(applied_vector_potential, s)
            tc_b = terminal_currents
        else:
            A_b = applied_vector_potential
            if dynamic_currents:
                tc_b = (lambda t, _f=terminal_currents, _s=s:
                        {k: v * _s for k, v in _f(t).items()})
            elif terminal_currents:
                tc_b = {k: v * s for k, v in terminal_currents.items()}
            else:
                tc_b = None
        solution = Solution(
            device=device,
            path=path,
            options=options,
            applied_vector_potential=A_b,
            terminal_currents=tc_b,
            disorder_epsilon=disorder_epsilon,
            total_seconds=0.0,
        )
        solution.to_hdf5()
        solutions.append(solution)
    return solutions


def _make_device_mesh(n_devices: Optional[int] = None) -> Mesh:
    devices = np.array(jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, axis_names=("batch",))


def solve_sweep(
    device: Device,
    options: SolverOptions,
    *,
    applied_vector_potential=0.0,
    terminal_currents=None,
    disorder_epsilon=1.0,
    field_scales: Optional[Sequence[float]] = None,
    current_scales: Optional[Sequence[float]] = None,
    mesh: Optional[Mesh] = None,
    max_steps: Optional[int] = None,
    raise_on_failure: bool = True,
    output_dir: Optional[str] = None,
) -> SweepResult:
    """Run a batch of TDGL solves in parallel across devices.

    Exactly one of ``field_scales`` or ``current_scales`` must be given; each
    batch member ``b`` solves the same problem with the applied vector
    potential (or every terminal current) multiplied by ``scales[b]``.

    Args:
        device: The meshed :class:`Device` (shared by all members).
        options: Solver options (``save_every`` sets the chunk size).
        applied_vector_potential: As in :func:`tdgl_tpu.solve`.
        terminal_currents: A dict (static bias) or a callable ``t -> dict``
            (the common IV-curve form). A callable is re-evaluated on the
            host at every chunk boundary, at each member's own simulation
            time — piecewise-constant in time at ``steps_per_chunk``
            resolution (set ``options.steps_per_chunk=1`` for per-step
            updates).
        disorder_epsilon: As in :func:`tdgl_tpu.solve`.
        field_scales: Multipliers for the applied vector potential.
        current_scales: Multipliers for all terminal currents.
        mesh: The device mesh (default: 1D mesh over all available devices).
        max_steps: Step cap (default: generous bound from dt_init).
        raise_on_failure: Raise ``RuntimeError`` if any member fails
            (discriminant-retry exhaustion / screening non-convergence).
            When False, failures are reported in ``SweepResult.failed``
            instead.
        output_dir: If given, write each member's final state to
            ``{output_dir}/member_{b:03d}.h5`` in the standard output
            schema and return full :class:`tdgl_tpu.Solution` objects in
            ``SweepResult.solutions`` — every sweep member then works with
            the whole analysis/plotting/CLI stack (fluxoids, currents
            through paths, ``python -m tdgl_tpu.visualize``, ...).

    Returns:
        A :class:`SweepResult`.
    """
    if (field_scales is None) == (current_scales is None):
        raise ValueError(
            "Exactly one of field_scales / current_scales must be given."
        )
    scales = np.asarray(
        field_scales if field_scales is not None else current_scales,
        dtype=float,
    )
    B = len(scales)
    if mesh is None:
        # The batch axis must divide evenly across devices; use the largest
        # device subset that divides B (worst case 1 device, all lanes).
        n_dev = len(jax.devices())
        while B % n_dev:
            n_dev -= 1
        mesh = _make_device_mesh(n_dev)

    dynamic_currents = callable(terminal_currents)
    solver = TDGLSolver(
        device, options,
        applied_vector_potential=applied_vector_potential,
        # A callable bias is handled by the batched per-chunk host update
        # below; the solver itself is constructed with the t=0 snapshot so
        # the compiled chunk stays host-sync-free.
        terminal_currents=(dict(terminal_currents(0.0)) if dynamic_currents
                           else terminal_currents),
        disorder_epsilon=disorder_epsilon,
    )
    if solver.host_dynamic:
        raise ValueError(
            "solve_sweep requires traced (jittable) or static A/epsilon"
            " parameters (callable terminal currents are supported)."
        )
    current_scale_vec = (scales if current_scales is not None
                         else np.ones(B))

    def batched_mu_boundary(times: np.ndarray) -> np.ndarray:
        """(B,) member times -> (B, n_boundary) Neumann BC values.

        Evaluates the user's callable at each member's own time, applies the
        member's bias scale, and nondimensionalizes with the solver's
        J_scale (as ``TDGLSolver.current_func`` does for the static path).
        """
        return np.stack([
            solver._mu_boundary_from_currents(
                {k: solver.J_scale * v * current_scale_vec[b]
                 for k, v in terminal_currents(float(times[b])).items()}
            )
            for b in range(B)
        ])
    base_state = solver._initial_state()
    structured = solver.structured

    def batched_neumann(times: np.ndarray) -> np.ndarray:
        """Grid-backend analog of :func:`batched_mu_boundary`: the dense
        pre-scattered Neumann term per member."""
        mb = batched_mu_boundary(times)
        return np.stack([solver._host_neumann_term(mb[b]) for b in range(B)])

    # Broadcast the state over the batch axis, scaling the swept input.
    def broadcast(leaf):
        return jnp.broadcast_to(leaf, (B,) + leaf.shape)

    batched = jax.tree.map(broadcast, base_state)
    scales_j = jnp.asarray(scales, base_state.A_applied.dtype)

    def bscale(leaf):
        return leaf * scales_j.reshape((B,) + (1,) * (leaf.ndim - 1))

    if field_scales is not None:
        batched = batched._replace(A_applied=bscale(batched.A_applied))
    elif dynamic_currents:
        if structured:
            batched = batched._replace(neumann_term=jnp.asarray(
                batched_neumann(np.zeros(B)), base_state.mu.dtype
            ))
        else:
            batched = batched._replace(mu_boundary=jnp.asarray(
                batched_mu_boundary(np.zeros(B)), base_state.mu.dtype
            ))
    elif structured:
        batched = batched._replace(
            neumann_term=bscale(batched.neumann_term)
        )
    else:
        batched = batched._replace(
            mu_boundary=bscale(batched.mu_boundary)
        )

    # Shard the batch axis across devices.
    def shard(leaf):
        return jax.device_put(
            leaf, NamedSharding(mesh, P("batch", *([None] * (leaf.ndim - 1))))
        )

    batched = jax.tree.map(shard, batched)

    chunk_size = solver.chunk_size
    chunk_fn = solver._raw_chunk_fn  # grid or ELL, per the device's mesh
    batched_chunk = jax.jit(
        jax.vmap(chunk_fn, in_axes=(None, None, None, 0))
    )
    op_arg = solver.sten if structured else solver.op

    if max_steps is None:
        max_steps = int(
            min(5e6, 10 * options.solve_time / options.dt_init)
        )
    outputs_list: List[StepOutputs] = []
    state = batched
    total = 0
    exported = None
    while total < max_steps:
        state, outputs, exported_dev = batched_chunk(
            op_arg, solver._screening_weights, solver.amg, state
        )
        outputs = tree_to_numpy(outputs)
        outputs_list.append(outputs)
        total += chunk_size
        exported = tree_to_numpy(exported_dev)
        # Under vmap the (6,) diagnostics vector becomes (B, 6).
        diag = exported["diagnostics"]
        if bool(np.all(diag[:, 4] > 0)):
            break
        if dynamic_currents:
            # Re-evaluate the bias at each member's own simulation time and
            # push the new Neumann BCs for the next chunk.
            if structured:
                nt = batched_neumann(diag[:, 0])
                state = state._replace(
                    neumann_term=shard(jnp.asarray(nt, base_state.mu.dtype))
                )
            else:
                mb = batched_mu_boundary(diag[:, 0])
                state = state._replace(
                    mu_boundary=shard(jnp.asarray(mb, base_state.mu.dtype))
                )
    diag = exported["diagnostics"]
    failed = diag[:, 5] > 0
    if raise_on_failure and bool(np.any(failed)):
        bad = ", ".join(
            f"{scales[b]:g}" for b in np.flatnonzero(failed)[:8]
        )
        raise RuntimeError(
            f"{int(failed.sum())}/{B} sweep members failed to converge"
            f" (scale values: {bad}). Pass raise_on_failure=False to get"
            " partial results with per-member flags."
        )
    # outputs have shape (B, chunk, ...) per chunk; concatenate along steps.
    dt = np.concatenate([np.asarray(o.dt) for o in outputs_list], axis=1)
    valid = np.concatenate([np.asarray(o.valid) for o in outputs_list],
                           axis=1)
    dt = np.where(valid, dt, 0.0)
    mu_p = np.concatenate([np.asarray(o.mu_probe) for o in outputs_list],
                          axis=1)  # (B, T, P)
    th_p = np.concatenate([np.asarray(o.theta_probe) for o in outputs_list],
                          axis=1)
    if structured:
        maps = solver.maps

        def g2s(g):
            return g.reshape(B, -1)[:, maps.site_flat]

        def g2e(g):
            return g.reshape((B, -1) + g.shape[4:])[:, maps.edge_flat]

        psi = g2s(exported["psi_real"]) + 1j * g2s(exported["psi_imag"])
        mu_final = g2s(exported["mu"])
        sc = g2e(exported["supercurrent"])
        nc = g2e(exported["normal_current"])
    else:
        psi = exported["psi_real"] + 1j * exported["psi_imag"]
        mu_final = exported["mu"]
        sc = exported["supercurrent"]
        nc = exported["normal_current"]
    steps_taken = exported["diagnostics"][:, 3].astype(int)
    dyn_mu = np.transpose(mu_p, (0, 2, 1))
    dyn_theta = np.transpose(th_p, (0, 2, 1))
    solutions = None
    if output_dir is not None:
        solutions = _write_member_solutions(
            output_dir, solver, device, options, exported, scales,
            steps_taken, dt, dyn_mu, dyn_theta, applied_vector_potential,
            terminal_currents, disorder_epsilon,
            field_sweep=(field_scales is not None),
            dynamic_currents=dynamic_currents,
        )
    return SweepResult(
        values=scales,
        psi=psi,
        mu=mu_final,
        supercurrent=sc,
        normal_current=nc,
        dynamics_dt=dt,
        dynamics_mu=dyn_mu,
        dynamics_theta=dyn_theta,
        steps=steps_taken,
        failed=failed,
        times=diag[:, 0],
        solutions=solutions,
    )
