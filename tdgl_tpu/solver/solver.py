"""TDGLSolver: problem assembly and execution.

API parity with the reference ``tdgl/solver/solver.py:88-827``: the same
constructor signature, nondimensionalization (A in units of A0, currents via
``J_scale = 4 (I/L)/K0``), terminal boundary conditions, disorder handling,
seed solutions, and HDF5 output. The execution backend is the compiled
chunked scan from :mod:`tdgl_tpu.solver.step`.

Time-dependent inputs run on one of two paths:

* **traced** (fast path): ``Parameter(..., jittable=True)`` promises the
  function is jax-traceable; it is evaluated inside the compiled step.
* **host** (parity path): plain Python callables are evaluated on the host
  every step (chunk size 1), matching the reference's behavior exactly.
"""

from __future__ import annotations

import inspect
import logging
import numbers
from datetime import datetime
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..device.device import Device, TerminalInfo
from ..utils import compile_cache
from ..utils.jaxio import host_scalar, to_numpy
from ..fv.operators import build_operators
from ..parameter import Parameter
from ..sources.constant import ConstantField
from ..utils.units import ureg
from .options import SolverOptions, SolverOptionsError
from .runner import DataHandler, Runner
from .step import SolverState, StepConfig, make_chunk_fn

logger = logging.getLogger("solver")


class _TracedInput:
    """Hashable wrapper for a traced time-dependent input closure.

    ``StepConfig`` is the compile-cache key for ``make_chunk_fn``; raw
    closures compare by identity, so every new solver would recompile even
    for identical physics. This wrapper compares by a value token — the
    Parameter's bytecode fingerprint, the nondimensionalization scale, and a
    digest of the coordinate arrays the closure bakes into the compiled
    program — so equal-physics solvers share compiled chunk programs.
    """

    __slots__ = ("_fn", "_token")

    def __init__(self, fn: Callable, token: tuple):
        self._fn = fn
        self._token = token

    def __call__(self, t):
        return self._fn(t)

    def __eq__(self, other):
        return (isinstance(other, _TracedInput)
                and other._token == self._token)

    def __hash__(self):
        return hash(self._token)


def _array_digest(*arrays: np.ndarray) -> str:
    import hashlib

    digest = hashlib.sha1()
    for arr in arrays:
        digest.update(np.ascontiguousarray(arr))
    return digest.hexdigest()


def _callable_fingerprint(fn: Callable) -> str:
    """Bytecode-based value token for a plain jittable callable (cf.
    ``Parameter.fingerprint``). Includes closure cell values so two closures
    with identical code but different captured constants (e.g. ramp rates)
    fingerprint differently."""
    import hashlib

    digest = hashlib.sha1()
    code = getattr(fn, "__code__", None)
    if code is None:  # callable object: fall back to its call method
        code = fn.__call__.__code__
        digest.update(repr(vars(fn)).encode())
    digest.update(code.co_code)
    digest.update(repr(code.co_consts).encode())
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            digest.update(repr(cell.cell_contents).encode())
        except ValueError:  # empty cell
            digest.update(b"<empty>")
    return digest.hexdigest()


def jittable(fn: Callable) -> Callable:
    """Mark a callable as jax-traceable (``fn.jittable = True``).

    Used for ``terminal_currents`` functions: a traced-current callable is
    evaluated *inside* the compiled TDGL step, so current ramps / IV sweeps
    keep the full fused chunk size instead of dropping to one step per
    host dispatch (the reference evaluates terminal currents in its Python
    loop every step, ``tdgl/solver/solver.py:325-345`` — one host dispatch
    per step).
    """
    fn.jittable = True
    return fn


class SolverResult(NamedTuple):
    """The per-step quantities produced by the solver (informational; the
    compiled runtime carries them in :class:`tdgl_tpu.solver.step.SolverState`
    instead of returning them per step). Mirrors the reference
    ``tdgl/solver/solver.py:63-86`` for API compatibility."""

    dt: float
    psi: "np.ndarray"
    mu: "np.ndarray"
    supercurrent: "np.ndarray"
    normal_current: "np.ndarray"
    A_induced: "np.ndarray"
    A_applied: "np.ndarray" = None
    epsilon: "np.ndarray" = None


def validate_terminal_currents(
    terminal_currents: Union[Callable, Dict[str, float]],
    terminal_info: Sequence[TerminalInfo],
    solver_options: SolverOptions,
    num_evals: int = 100,
) -> None:
    """Check that the terminal currents sum to zero (current conservation)."""

    def check(currents: Dict[str, float]) -> None:
        names = {t.name for t in terminal_info}
        unknown = set(currents) - names
        if unknown:
            raise ValueError(
                f"Unknown terminal(s) in terminal currents: {sorted(unknown)}."
            )
        total = sum(currents.values())
        if total:
            raise ValueError(
                f"The sum of all terminal currents must be 0 (got {total:.2e})."
            )

    if callable(terminal_currents):
        for t in np.random.default_rng(0).random(num_evals) * \
                solver_options.solve_time:
            check(terminal_currents(t))
    else:
        check(terminal_currents)


class TDGLSolver:
    """Solves a TDGL model for a given device.

    Args:
        device: The meshed :class:`tdgl_tpu.Device`.
        options: :class:`tdgl_tpu.SolverOptions`.
        applied_vector_potential: A float (uniform field strength in
            ``field_units``), or a Parameter/callable of ``(x, y, z)`` (and
            keyword ``t`` if time-dependent) returning the vector potential in
            ``field_units * length_units``.
        terminal_currents: Dict ``{terminal_name: current}`` or callable
            ``t -> dict`` (in ``current_units``).
        disorder_epsilon: Float (<= 1) or callable giving the local critical
            temperature parameter epsilon(r[, t]).
        seed_solution: A previous Solution used as the initial state.
    """

    def __init__(
        self,
        device: Device,
        options: SolverOptions,
        applied_vector_potential: Union[Callable, float] = 0.0,
        terminal_currents: Union[Callable, Dict[str, float], None] = None,
        disorder_epsilon: Union[Callable, float] = 1.0,
        seed_solution=None,
    ):
        self.device = device
        self.options = options
        options.validate()
        self.terminal_currents = terminal_currents
        self.seed_solution = seed_solution
        if options.compilation_cache:
            compile_cache.enable()

        if device.mesh is None:
            raise ValueError(
                "The device has no mesh; call device.make_mesh() first."
            )
        mesh = device.mesh
        self.mesh = mesh
        self.rdtype = np.float32 if options.dtype == "float32" else np.float64
        self.cdtype = (np.complex64 if options.dtype == "float32"
                       else np.complex128)

        xi = device.layer.coherence_length
        self.u = device.layer.u
        self.gamma = device.layer.gamma
        length_units = ureg(device.length_units)
        K0 = device.K0
        A0 = device.A0

        self.probe_points = device.probe_point_indices
        # Dimensionful coordinates for evaluating user-supplied fields.
        self.sites = xi * np.asarray(mesh.sites)
        self.edge_centers = xi * np.asarray(mesh.edge_mesh.centers)
        self.num_edges = len(mesh.edge_mesh.edges)
        self.z0 = device.layer.z0 * np.ones(len(self.edge_centers))

        # --- applied vector potential --------------------------------------
        self.dynamic_vector_potential = (
            isinstance(applied_vector_potential, Parameter)
            and applied_vector_potential.time_dependent
        )
        if not callable(applied_vector_potential):
            applied_vector_potential = ConstantField(
                applied_vector_potential,
                field_units=options.field_units,
                length_units=device.length_units,
            )
        self.applied_vector_potential = applied_vector_potential
        # A given in field_units * length_units; convert to units of A0:
        self.A_scale = float(
            (ureg(options.field_units) * length_units / A0)
            .to_base_units().magnitude
        )
        self._A_kwargs = (
            dict(t=0.0) if self.dynamic_vector_potential else dict()
        )
        current_A_applied = self._eval_A(0.0)

        # --- disorder epsilon ------------------------------------------------
        if callable(disorder_epsilon):
            spec = inspect.getfullargspec(disorder_epsilon)
            self.dynamic_epsilon = "t" in (spec.kwonlyargs or [])
            self.vectorized_epsilon = bool(
                (spec.kwonlydefaults or {}).get("vectorized", False)
            )
        else:
            value = float(disorder_epsilon)

            def disorder_epsilon(r, *, _value=value):
                return _value * np.ones(len(r))

            self.dynamic_epsilon = False
            self.vectorized_epsilon = True
        self.disorder_epsilon = disorder_epsilon
        epsilon = self._eval_epsilon(0.0)
        if np.any(epsilon > 1):
            raise ValueError("The disorder parameter epsilon must be <= 1.")

        # --- terminals -------------------------------------------------------
        self.terminal_info = device.terminal_info()
        self.terminal_names = [t.name for t in self.terminal_info]
        for info in self.terminal_info:
            if info.length == 0:
                raise ValueError(
                    f"Terminal {info.name!r} does not contain any boundary"
                    " mesh sites."
                )
        if terminal_currents and device.probe_points is None:
            logger.warning(
                "The terminal currents are non-null, but the device has no"
                " probe points."
            )
        if terminal_currents is None:
            terminal_currents = {name: 0.0 for name in self.terminal_names}
        if callable(terminal_currents):
            current_func = terminal_currents
            self.dynamic_currents = True
            self._jittable_currents = bool(
                getattr(terminal_currents, "jittable", False)
            )
        else:
            self._jittable_currents = False
            terminal_currents = {
                name: terminal_currents.get(name, 0.0)
                for name in self.terminal_names
            }
            self.dynamic_currents = False

            def current_func(t, _currents=terminal_currents):
                return _currents

        # Dimensionless current scale: edge supercurrent values are in units
        # of J0/4 = K0/(4 d), hence the factor 4 (cf. reference
        # ``solver.py:251`` and the unit convention notes in
        # ``models/gtdgl.edge_quantity_to_sites``).
        J_scale = (ureg(options.current_units) / length_units / K0)
        J_scale = 4.0 * float(J_scale.to_base_units().magnitude)
        self.J_scale = J_scale
        self.current_func = (
            lambda t: {k: J_scale * v for k, v in current_func(t).items()}
        )
        validate_terminal_currents(self.current_func, self.terminal_info,
                                   options)

        if self.terminal_info:
            normal_boundary_index = np.concatenate(
                [t.site_indices for t in self.terminal_info]
            ).astype(np.int32)
        else:
            normal_boundary_index = np.array([], dtype=np.int32)

        # --- backend selection -------------------------------------------------
        if options.solver_backend == "stencil" and mesh.grid is None:
            raise ValueError(
                "solver_backend='stencil' requires a structured mesh;"
                " generate one with device.make_mesh(structured=True)."
            )
        self.structured = (
            mesh.grid is not None and options.solver_backend != "ell"
        )
        if options.poisson_solver == "mg" and not self.structured:
            raise SolverOptionsError(
                "poisson_solver='mg' requires the structured (stencil)"
                " backend; generate a structured mesh with"
                " device.make_mesh(structured=True) or use"
                " poisson_solver='cg'."
            )
        # --- operators -------------------------------------------------------
        terminal_psi = options.terminal_psi
        fixed = (normal_boundary_index if terminal_psi is not None
                 else np.array([], dtype=np.int32))
        logger.info("Constructing finite volume operators.")
        host_op = build_operators(mesh, fixed_sites=fixed, dtype=self.rdtype)
        self.op = jax.tree.map(jnp.asarray, host_op)
        self.host_op = host_op
        if self.structured:
            from ..fv.stencil_operators import build_stencil_operators

            host_sten, self.maps = build_stencil_operators(
                mesh, fixed_sites=fixed, dtype=self.rdtype
            )
            self.host_sten = host_sten
            self.sten = jax.tree.map(jnp.asarray, host_sten)
            logger.info(
                "Stencil backend: padded grid %s (%.0f%% fill).",
                self.maps.shape,
                100.0 * self.maps.n_sites
                / (self.maps.shape[0] * self.maps.shape[1]),
            )

        # --- mu-Poisson preconditioner ---------------------------------------
        self._use_amg = options.poisson_preconditioner == "amg"
        if not self._use_amg:
            self.amg = None
        elif self.structured:
            from ..ops.hexmg import build_hexmg

            self.amg = build_hexmg(host_sten, self.maps, mesh)
            logger.info(
                "Built %d-level smoothed-aggregation multigrid: %s.",
                len(self.amg.shapes), self.amg.shapes,
            )
        else:
            from ..ops.amg import build_amg

            n_sites_total = len(mesh.sites)
            coarsening = options.amg_coarsening or max(
                16, n_sites_total // 1200
            )
            host_amg = build_amg(host_op, coarsening=coarsening,
                                 dtype=self.rdtype)
            self.amg = jax.tree.map(jnp.asarray, host_amg)
            logger.info(
                "Built two-level AMG preconditioner: %d aggregates"
                " (coarsening %d).", host_amg.Ac_inv.shape[0], coarsening,
            )

        # --- screening weights ------------------------------------------------
        screening_kernel = options.screening_kernel
        if screening_kernel == "auto":
            if self.structured:
                screening_kernel = "fft"
            else:
                screening_kernel = "xla"
        if screening_kernel == "fft" and not self.structured:
            raise ValueError(
                f"screening_kernel={screening_kernel!r} requires a"
                " structured mesh (Device.make_mesh(structured=True))."
            )
        self._screening_kernel = screening_kernel
        if options.include_screening:
            # weight_s = [mu_0/(4 pi) K0/A0] * xi * a_s (dimensionless a, r).
            A_scale_scr = (
                (ureg("mu_0") / (4 * np.pi) * K0 / A0).to(1 / length_units)
            ).magnitude
            weights = (A_scale_scr * xi) * np.asarray(mesh.areas)
        else:
            weights = np.zeros(len(mesh.sites))
        if self.structured:
            weights = jnp.asarray(
                self.maps.site_to_grid(weights.astype(self.rdtype))
            )
            fft_data = None
            self._site_taps = None
            if options.include_screening and screening_kernel == "fft":
                from ..ops.fft_screening import (
                    build_fft_screening,
                    build_site_interp_taps,
                )

                fft_data = build_fft_screening(
                    host_sten, self.maps, mesh.grid, dtype=self.rdtype,
                )
                self._site_taps = build_site_interp_taps(
                    host_sten, self.maps, mesh.grid
                )
                if (options.screening_site_eval is True
                        and self._site_taps is None):
                    raise SolverOptionsError(
                        "screening_site_eval=True but the mesh's valid"
                        " region sits too close to the padded-grid"
                        " boundary for the interpolation/correction"
                        " rolls to be wrap-safe on this mesh."
                    )
            self._screening_weights = (weights, fft_data)
        else:
            self._screening_weights = jnp.asarray(weights,
                                                  dtype=self.rdtype)

        # --- initial state -----------------------------------------------------
        n_sites = len(mesh.sites)
        n_boundary = len(host_op.boundary_edge_indices)
        psi_init = np.ones(n_sites, dtype=self.cdtype)
        if terminal_psi is not None:
            psi_init[normal_boundary_index] = terminal_psi
        mu_init = np.zeros(n_sites, dtype=self.rdtype)
        self.psi_init = psi_init
        self.mu_init = mu_init
        self.epsilon = np.asarray(epsilon, dtype=self.rdtype)
        self.current_A_applied = current_A_applied

        # --- time-dependence strategy -----------------------------------------
        self._jittable_A = (
            self.dynamic_vector_potential
            and getattr(self.applied_vector_potential, "jittable", False)
        )
        self._jittable_eps = (
            self.dynamic_epsilon
            and getattr(self.disorder_epsilon, "jittable", False)
        )
        self.host_dynamic = (
            (self.dynamic_vector_potential and not self._jittable_A)
            or (self.dynamic_epsilon and not self._jittable_eps)
            or (self.dynamic_currents and not self._jittable_currents)
        )

        A_fn = eps_fn = mu_boundary_fn = None
        if self._jittable_currents:
            # Terminal currents -> Neumann BC values is LINEAR with a static
            # matrix: density on terminal i's boundary edges is
            # (-1/length_i) * sum_{j != i} I_j (cf. _mu_boundary_from_
            # currents). Bake the (B, n_terminals) matrix and trace only the
            # user's currents function inside the step.
            n_b = len(host_op.boundary_edge_indices)
            T = np.zeros((n_b, len(self.terminal_names)), dtype=self.rdtype)
            for term in self.terminal_info:
                for j, name in enumerate(self.terminal_names):
                    if name != term.name:
                        T[term.boundary_edge_indices, j] = -1.0 / term.length
            names = tuple(self.terminal_names)
            raw_currents = current_func

            def mu_boundary_fn(t, _T=T, _names=names, _fn=raw_currents,
                               _scale=J_scale):
                currents = _fn(t)
                I_vec = jnp.stack(
                    [jnp.asarray(currents[name], dtype=_T.dtype) * _scale
                     for name in _names]
                )
                # HIGHEST: an f32 matmul may otherwise run in TF32 on
                # the GPU.
                return jnp.matmul(jnp.asarray(_T), I_vec,
                                  precision=jax.lax.Precision.HIGHEST)

            mu_boundary_fn = _TracedInput(mu_boundary_fn, (
                "currents", _callable_fingerprint(raw_currents),
                float(J_scale), names, _array_digest(T),
            ))

        if self._jittable_A:
            if self.structured:
                # Padded grid edge centers (invalid entries sit at the mesh
                # centroid, so user functions stay finite there).
                xe = (xi * np.asarray(self.host_sten.ec_x)).ravel()
                ye = (xi * np.asarray(self.host_sten.ec_y)).ravel()
                ze = device.layer.z0 * np.ones_like(xe)
                out_shape = (3,) + self.maps.shape + (2,)
            else:
                xe = self.edge_centers[:, 0]
                ye = self.edge_centers[:, 1]
                ze = self.z0
                out_shape = None

            def A_fn(t, _p=self.applied_vector_potential):
                A = _p.evaluate_traced(xe, ye, ze, t=t)
                A = self.A_scale * jnp.asarray(A)[:, :2]
                return A.reshape(out_shape) if out_shape else A

            A_fn = _TracedInput(A_fn, (
                "A", self.applied_vector_potential.fingerprint(),
                float(self.A_scale), _array_digest(xe, ye, ze),
            ))

        if self._jittable_eps:
            if self.structured:
                xs_x = (xi * np.asarray(self.host_sten.site_x)).ravel()
                xs_y = (xi * np.asarray(self.host_sten.site_y)).ravel()
                eps_shape = self.maps.shape

                def eps_fn(t, _p=self.disorder_epsilon):
                    return jnp.asarray(
                        _p.evaluate_traced(xs_x, xs_y, t=t)
                    ).reshape(eps_shape)

                eps_fn = _TracedInput(eps_fn, (
                    "eps", self.disorder_epsilon.fingerprint(),
                    _array_digest(xs_x, xs_y),
                ))
            else:
                xs = self.sites

                def eps_fn(t, _p=self.disorder_epsilon):
                    return jnp.asarray(
                        _p.evaluate_traced(xs[:, 0], xs[:, 1], t=t)
                    )

                eps_fn = _TracedInput(eps_fn, (
                    "eps", self.disorder_epsilon.fingerprint(),
                    _array_digest(xs),
                ))

        dt_max = options.dt_max if options.adaptive else options.dt_init
        poisson_tol = (
            float(options.poisson_tolerance)
            if options.poisson_tolerance is not None
            else (1e-4 if options.dtype == "float32" else 1e-6)
        )
        screening_global_norm = (
            options.screening_error_norm == "global"
            or (options.screening_error_norm == "auto"
                and options.dtype == "float32")
        )
        screening_tol = float(options.screening_tolerance)
        if options.include_screening:
            # Precision floor on the effective screening tolerance (see
            # SolverOptions.screening_tolerance_floor): at float32 the
            # coupled psi/mu/A map fluctuates at ~3e-4 relative no matter
            # how accurately the induced-A kernel sums, so tolerances below
            # the floor can never be met.
            floor = options.screening_tolerance_floor
            if floor is None:
                if options.dtype == "float32":
                    floor = 5e-4 if screening_global_norm else 3e-3
                else:
                    floor = 0.0
            if screening_tol < floor:
                logging.getLogger("solver").warning(
                    "screening_tolerance=%.1e is below the %s precision "
                    "floor %.1e for dtype=%s; using the floor (set "
                    "screening_tolerance_floor=0 to disable).",
                    screening_tol,
                    "global-norm" if screening_global_norm else "per-edge",
                    floor, options.dtype,
                )
                screening_tol = float(floor)
            # The Polyak fixed point compares successive induced vector
            # potentials; mu-solve noise enters through the normal current,
            # so CG must converge well below the screening tolerance.
            poisson_tol = min(poisson_tol, 1e-2 * screening_tol)
        self.cfg = StepConfig(
            gamma=float(self.gamma),
            u=float(self.u),
            adaptive=bool(options.adaptive),
            dt_init=float(options.dt_init),
            dt_max=float(dt_max),
            adaptive_window=int(options.adaptive_window),
            max_solve_retries=int(options.max_solve_retries),
            adaptive_time_step_multiplier=float(
                options.adaptive_time_step_multiplier
            ),
            include_screening=bool(options.include_screening),
            screening_global_error_norm=screening_global_norm,
            screening_use_fft=(self._screening_kernel == "fft"),
            # Auto resolves to False here (the robust program evaluates
            # the exact per-edge-class convolution); the fast chunk
            # program flips to the site-evaluated kernel below.
            screening_site_eval=(options.screening_site_eval is True),
            screening_site_taps=getattr(self, "_site_taps", None),
            screening_anderson=(options.screening_solver == "anderson"),
            screening_cg_iters=(
                int(options.screening_cg_iterations)
                if options.screening_cg_iterations is not None
                # MG-Richardson cycles contract faster per iteration than
                # MG-preconditioned-CG iterations track the same warm
                # start, so the fixed inner-solve count inside the
                # screening loop is smaller on the 'mg' path.
                else (4 if options.poisson_solver == "mg"
                      # f32 structured: 5 suffices for the f32-floored
                      # inner tolerance (measured at the 50k benchmark);
                      # f64 parity/gate runs chase ~1e-8 inner residuals
                      # and keep the deeper count.
                      else (5 if options.dtype == "float32" else 8)
                      if self.structured else 32)
            ),
            screening_tolerance=screening_tol,
            screening_step_size=float(options.screening_step_size),
            screening_step_drag=float(options.screening_step_drag),
            max_iterations_per_step=int(options.max_iterations_per_step),
            poisson_tolerance=poisson_tol,
            poisson_max_iterations=int(options.poisson_max_iterations),
            poisson_fixed_iters=self._poisson_fixed_iters(options),
            poisson_sstep=(bool(options.poisson_sstep)
                           if options.poisson_sstep is not None else False),
            poisson_predictor=(options.poisson_warm_start == "extrapolate"),
            poisson_use_mg=(options.poisson_solver == "mg"
                            and self.structured),
            # The smoother damping is tuned per preconditioner: for the
            # deep SA hierarchy (hexmg), a single 0.8-damped Jacobi sweep
            # (measured V-cycle contraction ~0.21; a Chebyshev two-sweep
            # pair reaches 0.09 but its extra applies cost more than the
            # iteration it saves); for
            # the ELL two-level block AMG, its validated scalar 0.6.
            amg_omega=(0.8 if self.structured else 0.6),
            # On the stencil backend probes are flat padded-grid indices.
            probe_ix=(
                tuple(int(self.maps.site_flat[p]) for p in self.probe_points)
                if self.structured and self.probe_points is not None
                else tuple(self.probe_points)
                if self.probe_points is not None else None
            ),
            A_fn=A_fn,
            eps_fn=eps_fn,
            mu_boundary_fn=mu_boundary_fn,
            use_amg=self._use_amg,
            # None = auto: 2 on the structured unscreened chunk (the
            # unrolled pair lets XLA overlap one step's serial CG
            # reductions with the neighbor step's elementwise planes).
            # Pure scheduling, math unchanged. Screened/unstructured
            # chunks keep 1 (unmeasured benefit, higher compile cost).
            scan_unroll=(
                int(options.scan_unroll)
                if options.scan_unroll is not None
                else (2 if self.structured
                      and not options.include_screening else 1)
            ),
        )
        fold = options.fold_link_weights
        if fold is None:
            # Auto: f32 structured only — f64 keeps the reference rounding
            # order for the step-for-step oracle parity pins.
            fold = self.structured and options.dtype == "float32"
        if fold or options.link_phase_bf16:
            import dataclasses

            self.cfg = dataclasses.replace(
                self.cfg, fold_link_weights=bool(fold),
                link_bf16=bool(options.link_phase_bf16 and fold),
            )
        if options.link_phase_bf16 and not fold:
            logger.warning(
                "link_phase_bf16 has no effect without fold_link_weights"
                " (explicit fold_link_weights=False, or a non-f32/"
                "non-structured solve)."
            )
        self._resolve_factor_link_phases(options)
        if self.host_dynamic:
            self.chunk_size = 1
        else:
            cap = int(options.steps_per_chunk or 4096)
            if options.save_every <= cap:
                self.chunk_size = options.save_every
            else:
                # Largest divisor of save_every that fits the cap, so
                # snapshots land exactly on chunk boundaries without
                # compiling an enormous scan.
                divisor = 1
                for d in range(1, cap + 1):
                    if options.save_every % d == 0:
                        divisor = d
                self.chunk_size = divisor
        if self.structured:
            from .grid_step import make_grid_chunk_fn

            self._raw_chunk_fn = make_grid_chunk_fn(self.cfg,
                                                    self.chunk_size)
            if self._resolve_chunk_failover(options):
                import dataclasses

                # The fast program: no retry/top-up while_loops, health
                # gates instead (StepConfig.fast_chunk). The robust
                # program (self._raw_chunk_fn) stays uncompiled until a
                # chunk actually trips a gate. With screening, the fast
                # program additionally runs scan unroll 2, a shallower
                # inner fixed-iteration count and the site-evaluated
                # convolution, all gated: a step the cheap program cannot
                # hold within the screening tolerance and mu-residual
                # gates rewinds to the robust program
                # (screening_cg_iterations deep, exact convolution).
                fast_over = {}
                fail_gate = 10.0 * float(self.cfg.poisson_tolerance)
                if self.cfg.include_screening:
                    if options.scan_unroll is None:
                        fast_over["scan_unroll"] = 2
                    sfi = options.screening_fast_iterations
                    if sfi is None and options.dtype == "float32":
                        sfi = min(3, self.cfg.screening_cg_iters)
                    if sfi is not None:
                        fast_over["screening_cg_iters"] = int(sfi)
                    if (options.screening_site_eval is None
                            and self.cfg.screening_use_fft
                            and self.cfg.screening_site_taps is not None
                            and options.dtype == "float32"):
                        fast_over["screening_site_eval"] = True
                elif (options.poisson_fixed_iterations is None
                        and options.poisson_tolerance is None
                        and self.cfg.poisson_fixed_iters == 2):
                    # Gated fixed-1 mu solve (round 5, unscreened auto
                    # f32 structured path only): ONE MG-CG iteration per
                    # step committed iff the residual holds a 1e-2 fail
                    # gate; trips rewind the chunk to the robust program
                    # (fixed-2 + tolerance-stopped top-up at 1e-4).
                    # Physics validated by the extended tolerance ladder (psi/mu errors vs
                    # f64 flat through tolerance-stopped 1e-2 on both
                    # transport and vortex workloads) and the fixed-1
                    # trajectory row (tools/tol_study.py,
                    # docs/validation.md). Explicit poisson_tolerance or
                    # poisson_fixed_iterations disables the override.
                    fast_over["poisson_fixed_iters"] = 1
                    fail_gate = 1e-2
                self._fast_cfg = dataclasses.replace(
                    self.cfg, fast_chunk=True,
                    poisson_fail_gate=fail_gate,
                    **fast_over,
                )
                self._fast_chunk_fn = make_grid_chunk_fn(self._fast_cfg,
                                                         self.chunk_size)
                self._failover_count = 0

                def chunk_fn(state):
                    out = self._fast_chunk_fn(
                        self.sten, self._screening_weights, self.amg, state
                    )
                    # diagnostics[5] is the chunk's sticky failed flag.
                    if not bool(to_numpy(out[2]["diagnostics"])[5]):
                        return out
                    self._failover_count += 1
                    logger.info(
                        "fast chunk flagged an anomalous step; rewinding"
                        " and re-running the chunk with the robust"
                        " (retry/top-up) program"
                        + (" [compiling it first]"
                           if self._failover_count == 1 else "")
                    )
                    return self._raw_chunk_fn(
                        self.sten, self._screening_weights, self.amg, state
                    )

                self.chunk_fn = chunk_fn
            else:
                self.chunk_fn = lambda state: self._raw_chunk_fn(
                    self.sten, self._screening_weights, self.amg, state
                )
        else:
            # Validates the mode (chunk_failover='on' raises here — the
            # fast-chunk program exists only on the stencil backend).
            self._resolve_chunk_failover(options)
            self._raw_chunk_fn = make_chunk_fn(self.cfg, self.chunk_size)
            # The operator tables, screening weights, and AMG hierarchy are
            # traced arguments of the compiled chunk (not baked-in
            # constants).
            self.chunk_fn = lambda state: self._raw_chunk_fn(
                self.op, self._screening_weights, self.amg, state
            )

    def _resolve_chunk_failover(self, options: SolverOptions) -> bool:
        """Resolve ``SolverOptions.chunk_failover`` (see options.py).

        Auto = on for structured solves: the per-step retry/top-up
        while_loops are pure insurance that taxes every step, and
        chunk-level rewind provides the same
        repair semantics. With screening, the fast program additionally
        runs the Anderson fixed point as ONE inline iteration (measured
        steady-state mean: exactly 1.00 iterations/step) gated on the
        screening tolerance — a step needing more iterations fails over.
        """
        mode = options.chunk_failover
        if mode == "off":
            return False
        supported = self.structured
        if mode == "on" and not supported:
            raise SolverOptionsError(
                "chunk_failover='on' requires the structured (stencil)"
                " backend; use 'auto' to enable it opportunistically."
            )
        return supported

    def _poisson_fixed_iters(self, options: SolverOptions) -> Optional[int]:
        """Resolve ``poisson_fixed_iterations`` (None = auto, 0 = forced
        tolerance-stopped; see SolverOptions). Auto picks a fixed
        2-iteration MG-CG solve on the float32 structured deep-multigrid
        path regardless of warm-start mode: the fixed phase covers the
        easy/steady steps, and the tolerance-stopped top-up supplies
        whatever the hard (vortex-entry / dense-lattice) steps still need
        — measured ~3 total iterations/step in the 50k benchmark's hard
        window with the default plain warm start. The per-step residual
        gate still fails loudly if a geometry needs more."""
        pf = options.poisson_fixed_iterations
        if pf is not None:
            return int(pf) if pf > 0 else None
        if (self.structured and self._use_amg
                and options.dtype == "float32"
                and options.poisson_solver == "cg"):
            return 2
        return None

    def _full_grid_A64(self) -> np.ndarray:
        """The applied potential at EVERY padded-grid edge center
        (float64, A0 units) — the smooth extension of
        ``current_A_applied`` used by the factored-link-phase fast path
        and its separability check. The structured lattice is affine in
        the (row, col) indices (``x = x0 + (c + r/2) h``,
        ``y = y0 + r h sqrt(3)/2`` — device/hexmesh.py), so true edge
        centers exist at every padded position."""
        grid = self.mesh.grid
        h = float(grid.spacing)
        x0, y0 = float(grid.origin[0]), float(grid.origin[1])
        dy = h * np.sqrt(3.0) / 2.0
        Rp, Cp = self.maps.shape
        rr = np.arange(Rp, dtype=np.float64)[:, None]
        cc = np.arange(Cp, dtype=np.float64)[None, :]
        sx = x0 + (cc + 0.5 * rr) * h
        sy = np.broadcast_to(y0 + rr * dy, sx.shape)
        # Class offsets in xy (== sten.edge_dirs / h): E, N, NW.
        offs_xy = np.array([[h, 0.0], [0.5 * h, dy], [-0.5 * h, dy]])
        xi = float(self.device.layer.coherence_length)
        ecx = (sx[None] + 0.5 * offs_xy[:, 0][:, None, None]) * xi
        ecy = (sy[None] + 0.5 * offs_xy[:, 1][:, None, None]) * xi
        pts_x = ecx.reshape(-1)
        pts_y = ecy.reshape(-1)
        z0 = self.device.layer.z0 * np.ones(len(pts_x))
        A = self.applied_vector_potential(pts_x, pts_y, z0,
                                          **self._A_kwargs)
        A = self.A_scale * np.asarray(A, dtype=np.float64)[:, :2]
        return A.reshape(3, Rp, Cp, 2)

    def _resolve_factor_link_phases(self, options: SolverOptions) -> None:
        """Resolve ``SolverOptions.factor_link_phases`` (None = auto).

        Auto enables the rank-structured link-phase path on float32
        structured static-A unscreened solves when the applied potential
        passes a float64 separability check (max |a - f - g| <= 1e-9
        relative over the full padded grid); explicit True additionally
        raises on ineligible configurations or a non-separable potential.
        Sets ``cfg.factor_link_phases`` (clearing ``fold_link_weights``,
        which it supersedes) and caches the smooth full-grid applied
        potential for the state fill.
        """
        import dataclasses

        self._full_A_grid = None
        opt = options.factor_link_phases
        eligible = (
            self.structured
            and not self.dynamic_vector_potential
            and not options.include_screening
        )
        if opt is False or (opt is None and (
                not eligible or options.dtype != "float32")):
            return
        if opt and not eligible:
            raise SolverOptionsError(
                "factor_link_phases requires a structured mesh, a static"
                " (time-independent) applied vector potential and"
                " screening off."
            )
        A64 = self._full_grid_A64()
        dirs = np.asarray(self.host_sten.edge_dirs, np.float64)
        a = (A64[..., 0] * dirs[:, 0, None, None]
             + A64[..., 1] * dirs[:, 1, None, None])
        f = a[:, :, :1]
        g = a[:, :1, :] - a[:, :1, :1]
        scale = max(float(np.abs(a).max()), 1e-30)
        sep_err = float(np.abs(a - (f + g)).max()) / scale
        if sep_err > 1e-9:
            if opt:
                raise SolverOptionsError(
                    "factor_link_phases=True, but the applied vector"
                    f" potential is not separable on the lattice (relative"
                    f" deviation {sep_err:.1e}); use fold_link_weights"
                    " instead."
                )
            logger.info(
                "factor_link_phases auto-off: applied potential not"
                " separable (relative deviation %.1e).", sep_err,
            )
            return
        self._full_A_grid = A64
        self.cfg = dataclasses.replace(
            self.cfg, factor_link_phases=True, fold_link_weights=False,
            link_bf16=False,
        )
        logger.info(
            "Factored link phases enabled (separability deviation %.1e).",
            sep_err,
        )

    # -- host-side evaluation helpers ---------------------------------------
    def _eval_A(self, time: float) -> np.ndarray:
        kwargs = (dict(t=time) if self.dynamic_vector_potential else dict())
        A = self.applied_vector_potential(
            self.edge_centers[:, 0], self.edge_centers[:, 1], self.z0,
            **kwargs,
        )
        A = self.A_scale * np.asarray(A)[:, :2]
        if A.shape != self.edge_centers.shape:
            raise ValueError(
                f"Unexpected shape for vector_potential: {A.shape}."
            )
        return A.astype(self.rdtype)

    def _eval_epsilon(self, time: float) -> np.ndarray:
        kwargs = dict(t=time) if self.dynamic_epsilon else dict()
        if self.vectorized_epsilon:
            eps = self.disorder_epsilon(self.sites, **kwargs)
        else:
            eps = np.array(
                [float(self.disorder_epsilon(r, **kwargs))
                 for r in self.sites]
            )
        return np.asarray(eps, dtype=self.rdtype)

    def _mu_boundary(self, time: float) -> np.ndarray:
        """Terminal current densities -> Neumann BC values per boundary edge
        (``bc-current`` in the reference docs)."""
        return self._mu_boundary_from_currents(self.current_func(time))

    def _mu_boundary_from_currents(
        self, currents: Dict[str, float]
    ) -> np.ndarray:
        """Neumann BC values for an explicit dict of (already nondimensional)
        terminal currents."""
        mu_boundary = np.zeros(len(self.host_op.boundary_edge_indices),
                               dtype=self.rdtype)
        for term in self.terminal_info:
            density = (-1.0 / term.length) * sum(
                currents.get(name, 0.0)
                for name in self.terminal_names
                if name != term.name
            )
            mu_boundary[term.boundary_edge_indices] = density
        return mu_boundary

    def _host_neumann_term(self, mu_boundary: np.ndarray) -> np.ndarray:
        """Dense (grid) Neumann RHS term for a boundary-edge value vector."""
        sten = self.host_sten
        flat = np.zeros(self.maps.shape[0] * self.maps.shape[1],
                        dtype=self.rdtype)
        np.add.at(flat, sten.nbl_idx,
                  sten.nbl_vals * mu_boundary[sten.nbl_col])
        return flat.reshape(self.maps.shape)

    def _host_update(self, state):
        """Evaluate non-traceable time-dependent inputs on the host
        (chunk size 1)."""
        time = float(host_scalar(state.time))
        updates = {}
        if self.dynamic_vector_potential and not self._jittable_A:
            A_new = self._eval_A(time)
            prev_dt = float(host_scalar(state.prev_dt))
            ndirs = (self.host_op.edge_directions
                     / np.linalg.norm(self.host_op.edge_directions, axis=1,
                                      keepdims=True))
            if self.structured:
                prev = self.maps.grid_to_edge(to_numpy(state.A_applied))
                dA_dt = np.einsum("ij,ij->i", (A_new - prev) / prev_dt,
                                  ndirs)
                updates["A_applied"] = jnp.asarray(
                    self.maps.edge_to_grid(A_new)
                )
                updates["dA_dt"] = jnp.asarray(self.maps.edge_to_grid(
                    dA_dt.astype(self.rdtype)
                ))
            else:
                prev = to_numpy(state.A_applied)
                dA_dt = np.einsum("ij,ij->i", (A_new - prev) / prev_dt,
                                  ndirs)
                updates["A_applied"] = jnp.asarray(A_new)
                updates["dA_dt"] = jnp.asarray(dA_dt.astype(self.rdtype))
        if self.dynamic_epsilon and not self._jittable_eps:
            eps = self._eval_epsilon(time)
            if self.structured:
                eps = self.maps.site_to_grid(eps)
            updates["epsilon"] = jnp.asarray(eps)
        if self.dynamic_currents:
            mu_b = self._mu_boundary(time)
            if self.structured:
                updates["neumann_term"] = jnp.asarray(
                    self._host_neumann_term(mu_b)
                )
            else:
                updates["mu_boundary"] = jnp.asarray(mu_b)
        if updates:
            state = state._replace(**updates)
        return state

    # -- state assembly ---------------------------------------------------------
    def _initial_state(self) -> SolverState:
        options = self.options
        n_edges = self.num_edges
        if self.seed_solution is not None:
            if self.seed_solution.device != self.device:
                raise ValueError(
                    "The seed_solution.device must match the device being"
                    " simulated."
                )
            seed = self.seed_solution.tdgl_data
            psi = np.asarray(seed.psi, dtype=self.cdtype)
            mu = np.asarray(seed.mu, dtype=self.rdtype)
            supercurrent = np.asarray(seed.supercurrent, dtype=self.rdtype)
            normal_current = np.asarray(seed.normal_current,
                                        dtype=self.rdtype)
            A_induced = np.asarray(seed.induced_vector_potential,
                                   dtype=self.rdtype)
        else:
            psi = self.psi_init
            mu = self.mu_init
            supercurrent = np.zeros(n_edges, dtype=self.rdtype)
            normal_current = np.zeros(n_edges, dtype=self.rdtype)
            A_induced = np.zeros((n_edges, 2), dtype=self.rdtype)
        rd = self.rdtype
        if self.structured:
            return self._initial_grid_state(
                psi, mu, supercurrent, normal_current, A_induced
            )
        # Host-side export view of the initial state (used for the step-0
        # snapshot; no device round trip needed).
        self._initial_export = dict(
            psi_real=np.real(psi).astype(rd),
            psi_imag=np.imag(psi).astype(rd),
            mu=np.asarray(mu, rd),
            supercurrent=np.asarray(supercurrent, rd),
            normal_current=np.asarray(normal_current, rd),
            induced_vector_potential=np.asarray(A_induced, rd),
            applied_vector_potential=self.current_A_applied.astype(rd),
            epsilon=np.asarray(self.epsilon, rd),
            diagnostics=np.array(
                [0.0, options.dt_init, options.dt_init, 0.0, 0.0, 0.0],
                np.float32,
            ),
        )
        # The ELL state stores psi as an (N, 2) re/im pair (see
        # models/gtdgl.py).
        psi_pair = np.stack([np.real(psi), np.imag(psi)], axis=-1)
        return SolverState(
            psi=jnp.asarray(psi_pair, dtype=rd),
            mu=jnp.asarray(mu),
            mu_prev=jnp.asarray(mu),
            supercurrent=jnp.asarray(supercurrent),
            normal_current=jnp.asarray(normal_current),
            A_induced=jnp.asarray(A_induced),
            A_applied=jnp.asarray(self.current_A_applied.astype(rd)),
            epsilon=jnp.asarray(self.epsilon),
            mu_boundary=jnp.asarray(self._mu_boundary(0.0)),
            dA_dt=jnp.zeros(n_edges, rd),
            tentative_dt=jnp.asarray(options.dt_init, rd),
            prev_dt=jnp.asarray(options.dt_init, rd),
            time=jnp.asarray(0.0, rd),
            step=jnp.asarray(0, jnp.int32),
            dpsi_window=jnp.zeros(options.adaptive_window, rd),
            end_time=jnp.asarray(options.solve_time, rd),
            done=jnp.asarray(False),
            failed=jnp.asarray(False),
        )

    def _initial_grid_state(self, psi, mu, supercurrent, normal_current,
                            A_induced):
        """Assemble the grid-backend state (and its step-0 export dict)."""
        options = self.options
        rd = self.rdtype
        maps = self.maps
        s2g = maps.site_to_grid
        e2g = maps.edge_to_grid
        psi_r = s2g(np.ascontiguousarray(np.real(psi), dtype=rd))
        psi_i = s2g(np.ascontiguousarray(np.imag(psi), dtype=rd))
        if getattr(self, "_full_A_grid", None) is not None:
            # Factored-link-phase path: fill the WHOLE padded grid with the
            # smooth applied potential (masked consumers zero invalid edges
            # via weights/psi), so the in-program row/col factor extraction
            # reads true values everywhere.
            A_applied = self._full_A_grid.astype(rd)
        else:
            A_applied = e2g(self.current_A_applied.astype(rd))
        mu_b = self._mu_boundary(0.0)
        self._initial_export = dict(
            psi_real=psi_r,
            psi_imag=psi_i,
            mu=s2g(np.asarray(mu, rd)),
            supercurrent=e2g(np.asarray(supercurrent, rd)),
            normal_current=e2g(np.asarray(normal_current, rd)),
            induced_vector_potential=e2g(np.asarray(A_induced, rd)),
            applied_vector_potential=A_applied,
            epsilon=s2g(np.asarray(self.epsilon, rd)),
            diagnostics=np.array(
                [0.0, options.dt_init, options.dt_init, 0.0, 0.0, 0.0],
                np.float32,
            ),
        )
        from .grid_step import GridState

        shape3 = (3,) + maps.shape
        return GridState(
            psi_r=jnp.asarray(psi_r),
            psi_i=jnp.asarray(psi_i),
            mu=jnp.asarray(s2g(np.asarray(mu, rd))),
            mu_prev=jnp.asarray(s2g(np.asarray(mu, rd))),
            supercurrent=jnp.asarray(e2g(np.asarray(supercurrent, rd))),
            normal_current=jnp.asarray(e2g(np.asarray(normal_current, rd))),
            A_induced=jnp.asarray(e2g(np.asarray(A_induced, rd))),
            A_applied=jnp.asarray(A_applied),
            epsilon=jnp.asarray(s2g(np.asarray(self.epsilon, rd))),
            neumann_term=jnp.asarray(self._host_neumann_term(mu_b)),
            dA_dt=jnp.zeros(shape3, rd),
            tentative_dt=jnp.asarray(options.dt_init, rd),
            prev_dt=jnp.asarray(options.dt_init, rd),
            time=jnp.asarray(0.0, rd),
            step=jnp.asarray(0, jnp.int32),
            dpsi_window=jnp.zeros(options.adaptive_window, rd),
            end_time=jnp.asarray(options.solve_time, rd),
            done=jnp.asarray(False),
            failed=jnp.asarray(False),
        )

    def _state_to_arrays(self, exported: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
        """Convert the (host numpy) exported-state dict from
        ``step.export_state_arrays`` into the snapshot schema."""
        if self.structured:
            g2s = self.maps.grid_to_site
            g2e = self.maps.grid_to_edge
            data = dict(
                psi=g2s(exported["psi_real"])
                + 1j * g2s(exported["psi_imag"]),
                mu=g2s(exported["mu"]),
                supercurrent=g2e(exported["supercurrent"]),
                normal_current=g2e(exported["normal_current"]),
                induced_vector_potential=g2e(
                    exported["induced_vector_potential"]
                ),
            )
            if self.dynamic_vector_potential:
                data["applied_vector_potential"] = g2e(
                    exported["applied_vector_potential"]
                )
            if self.dynamic_epsilon:
                data["epsilon"] = g2s(exported["epsilon"])
            return data
        data = dict(
            psi=exported["psi_real"] + 1j * exported["psi_imag"],
            mu=exported["mu"],
            supercurrent=exported["supercurrent"],
            normal_current=exported["normal_current"],
            induced_vector_potential=exported["induced_vector_potential"],
        )
        if self.dynamic_vector_potential:
            data["applied_vector_potential"] = exported[
                "applied_vector_potential"
            ]
        if self.dynamic_epsilon:
            data["epsilon"] = exported["epsilon"]
        return data

    # -- main entry point ----------------------------------------------------------
    def _mesh_fingerprint(self) -> str:
        """SHA1 of the dimensionless mesh geometry (sites + elements).

        Stored in every checkpoint and verified on resume: padded grid
        shapes alone can coincide for different meshes, so a shape check
        cannot catch resuming onto the wrong geometry."""
        import hashlib

        h = hashlib.sha1()
        h.update(np.ascontiguousarray(self.mesh.sites, np.float64).tobytes())
        h.update(np.ascontiguousarray(self.mesh.elements, np.int64).tobytes())
        return h.hexdigest()

    def _resume_state(self, resume_from: str, template):
        """Load the ``checkpoint`` group of a previous run's output file and
        return ``(state, initial_export)`` reproducing that run's exact
        device state (see ``SolverOptions.save_checkpoints``). The solver
        must be constructed with the same mesh, dtype, and backend as the
        checkpointed run; every mismatch raises a ``ValueError``."""
        import h5py
        with h5py.File(resume_from, "r") as f:
            if "checkpoint" not in f:
                raise ValueError(
                    f"{resume_from!r} contains no checkpoint: the run was"
                    " saved with save_checkpoints=False, was cancelled"
                    " during thermalization, or predates checkpoint"
                    " support."
                )
            grp = f["checkpoint"]
            backend = grp.attrs.get("backend", "")
            expected = "grid" if self.structured else "ell"
            if backend != expected:
                raise ValueError(
                    f"Checkpoint backend {backend!r} does not match this"
                    f" solver's {expected!r} (make_mesh(structured="
                    f"{'True' if backend == 'grid' else 'False'}) to"
                    " match)."
                )
            fingerprint = grp.attrs.get("mesh_fingerprint", "")
            if fingerprint != self._mesh_fingerprint():
                raise ValueError(
                    "Checkpoint mesh does not match this solver's mesh:"
                    " resuming requires the SAME device and mesh as the"
                    " checkpointed run (site/element fingerprint differs)."
                )
            fields = {}   # host numpy values, keyed by state field name
            for name in template._fields:
                tmpl = getattr(template, name)
                if name in ("done", "failed", "end_time"):
                    continue  # reset below / set per stage by the runner
                if name in grp:
                    arr = np.asarray(grp[name])
                    if tuple(arr.shape) != tuple(tmpl.shape):
                        raise ValueError(
                            f"Checkpoint field {name!r} has shape"
                            f" {arr.shape}, expected {tuple(tmpl.shape)}:"
                            " resuming requires the same device, mesh, and"
                            " options as the checkpointed run."
                        )
                    if np.dtype(arr.dtype) != np.dtype(tmpl.dtype):
                        raise ValueError(
                            f"Checkpoint field {name!r} has dtype"
                            f" {arr.dtype}, expected {np.dtype(tmpl.dtype)}:"
                            " resume with the same SolverOptions.dtype as"
                            " the checkpointed run."
                        )
                    fields[name] = arr
                elif name in grp.attrs:
                    fields[name] = np.asarray(
                        grp.attrs[name], dtype=np.dtype(tmpl.dtype)
                    )
                else:
                    raise ValueError(
                        f"Checkpoint is missing state field {name!r}."
                    )
            time_val = float(grp.attrs["time"])
            if time_val >= self.options.solve_time:
                raise ValueError(
                    f"The checkpoint is already at t = {time_val:.6g} >="
                    f" solve_time = {self.options.solve_time}: raise"
                    " solve_time to continue the run."
                )
        if (getattr(self.cfg, "factor_link_phases", False)
                and self._full_A_grid is not None):
            # The factored-link path extracts its row/col phase factors
            # in-program from state.A_applied, which must be the SMOOTH
            # full-grid fill — a checkpoint written by a solver that
            # stored the masked (edge-scattered) grid would silently
            # yield wrong link phases. Repair checkpoints that match at
            # the real edges (same physics, masked fill) in place; reject
            # anything else.
            smooth = self._full_A_grid
            tol = dict(rtol=1e-5,
                       atol=1e-6 * max(float(np.abs(smooth).max()), 1e-30))
            ck = np.asarray(fields["A_applied"], np.float64)
            if not np.allclose(ck, smooth, **tol):
                at_edges = ck.reshape(3 * ck.shape[1] * ck.shape[2], 2)[
                    self.maps.edge_flat
                ]
                if not np.allclose(
                        at_edges, self.current_A_applied.astype(np.float64),
                        **tol):
                    raise ValueError(
                        "Checkpoint A_applied does not match this solver's"
                        " applied potential; resume with the same"
                        " applied_vector_potential, or set"
                        " factor_link_phases=False."
                    )
                fields["A_applied"] = smooth.astype(
                    np.asarray(fields["A_applied"]).dtype
                )
        state = template._replace(
            **{k: jnp.asarray(v) for k, v in fields.items()},
            done=jnp.asarray(False),
            failed=jnp.asarray(False),
        )
        # Host view of the resumed state for the step-0 snapshot.
        rd = self.rdtype
        if self.structured:
            psi_real = np.asarray(fields["psi_r"])
            psi_imag = np.asarray(fields["psi_i"])
        else:
            psi_pair = np.asarray(fields["psi"])
            psi_real = psi_pair[..., 0]
            psi_imag = psi_pair[..., 1]
        export = dict(
            psi_real=psi_real,
            psi_imag=psi_imag,
            mu=np.asarray(fields["mu"]),
            supercurrent=np.asarray(fields["supercurrent"]),
            normal_current=np.asarray(fields["normal_current"]),
            induced_vector_potential=np.asarray(fields["A_induced"]),
            applied_vector_potential=np.asarray(fields["A_applied"]),
            epsilon=np.asarray(fields["epsilon"]).astype(rd),
            diagnostics=np.array(
                [float(fields["time"]), float(fields["prev_dt"]),
                 float(fields["tentative_dt"]), float(fields["step"]),
                 0.0, 0.0],
                np.float32,
            ),
        )
        return state, export

    def solve(self, resume_from: Optional[str] = None):
        """Run the simulation; returns a :class:`tdgl_tpu.Solution` (or None
        if cancelled during thermalization).

        Args:
            resume_from: Path to a previous run's output file. The solver
                state is restored EXACTLY from that file's ``checkpoint``
                group (written at every snapshot when
                ``SolverOptions.save_checkpoints`` is on), so the continued
                trajectory is step-for-step identical to an uninterrupted
                run; output goes to this run's own ``output_file`` and the
                time axis continues from the checkpoint. Preemption-safe
                long runs: checkpoint + resume_from. (The reference's only
                warm restart, ``seed_solution``, re-seeds fields but loses
                the integrator state.)
        """
        from ..solution.solution import Solution

        start_time = datetime.now()
        options = self.options
        options.validate()

        running = {"dt": 1}
        if self.probe_points is not None:
            running["mu"] = len(self.probe_points)
            running["theta"] = len(self.probe_points)
        if options.include_screening:
            running["screening_iterations"] = 1

        state = self._initial_state()
        if resume_from is not None:
            if self.seed_solution is not None:
                raise ValueError(
                    "Pass either seed_solution or resume_from, not both."
                )
            state, self._initial_export = self._resume_state(
                resume_from, state
            )
        fixed = {}
        if not self.dynamic_vector_potential:
            fixed["applied_vector_potential"] = self.current_A_applied
        if not self.dynamic_epsilon:
            fixed["epsilon"] = self.epsilon

        with DataHandler(output_file=options.output_file,
                         logger=logger) as data_handler:
            data_handler.save_mesh(self.mesh)
            data_handler.save_fixed_values(fixed)
            if data_handler.tmp_file is not None:
                self.device.to_hdf5(
                    data_handler.tmp_file.create_group("solution/device")
                )
            logger.info(
                "Simulation started at %s on backend %r (chunk size %d).",
                start_time, jax.default_backend(), self.chunk_size,
            )
            runner = Runner(
                chunk_fn=self.chunk_fn,
                initial_state=state,
                options=options,
                data_handler=data_handler,
                state_to_arrays=self._state_to_arrays,
                running_names_and_sizes=running,
                chunk_size=self.chunk_size,
                initial_export=self._initial_export,
                host_update_fn=(self._host_update if self.host_dynamic
                                else None),
                monitor=options.monitor,
                monitor_update_interval=options.monitor_update_interval,
                logger=logger,
                checkpoint_meta={
                    "backend": "grid" if self.structured else "ell",
                    "mesh_fingerprint": self._mesh_fingerprint(),
                },
                resume=(resume_from is not None),
            )
            data_was_generated = runner.run()
            end_time = datetime.now()
            logger.info("Simulation ended at %s (took %s).", end_time,
                        end_time - start_time)
            if not data_was_generated:
                return None
            solution = Solution(
                device=self.device,
                path=data_handler.output_path,
                options=options,
                applied_vector_potential=self.applied_vector_potential,
                terminal_currents=self.terminal_currents,
                disorder_epsilon=self.disorder_epsilon,
                total_seconds=(end_time - start_time).total_seconds(),
            )
            solution.to_hdf5()
            return solution
