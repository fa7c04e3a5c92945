"""Solver feature tests: warm restarts (seed_solution), the traced
(jittable) time-dependent fast path vs the host path, thermalization, and
fixed-dt mode."""

import jax
import numpy as np
import pytest

import tdgl_tpu as tdgl
from tdgl_tpu.geometry import box
from tdgl_tpu.parameter import Parameter


@pytest.fixture(scope="module")
def small_device():
    layer = tdgl.Layer(coherence_length=1.0, london_lambda=2, thickness=0.1)
    film = tdgl.Polygon("film", points=box(8)).resample(150)
    device = tdgl.Device("film", layer=layer, film=film,
                         probe_points=[(-3, 0), (3, 0)])
    device.make_mesh(min_points=500, smooth=20)
    return device


def test_seed_solution(small_device, tmp_path):
    options = tdgl.SolverOptions(
        solve_time=4, dt_init=1e-4, save_every=100,
        field_units="uT", current_units="uA",
        output_file=str(tmp_path / "first.h5"),
    )
    first = tdgl.solve(small_device, options,
                       applied_vector_potential=tdgl.ConstantField(
                           80, field_units="uT"))
    options2 = tdgl.SolverOptions(
        solve_time=2, dt_init=1e-4, save_every=100,
        field_units="uT", current_units="uA",
        output_file=str(tmp_path / "second.h5"),
    )
    second = tdgl.solve(small_device, options2,
                        applied_vector_potential=tdgl.ConstantField(
                            80, field_units="uT"),
                        seed_solution=first)
    # The seeded run's step-0 snapshot equals the seed's final state.
    second.solve_step = 0
    np.testing.assert_allclose(
        np.asarray(second.tdgl_data.psi), np.asarray(first.tdgl_data.psi),
        atol=1e-7,
    )
    # And it must not restart from the uniform state.
    second.solve_step = -1
    assert np.abs(second.tdgl_data.psi).min() < 1.0 - 1e-4


def test_seed_solution_device_mismatch(small_device, tmp_path):
    options = tdgl.SolverOptions(
        solve_time=1, dt_init=1e-4,
        output_file=str(tmp_path / "a.h5"),
    )
    sol = tdgl.solve(small_device, options)
    other = small_device.copy()
    other.layer.thickness *= 3
    options2 = tdgl.SolverOptions(
        solve_time=1, dt_init=1e-4, output_file=str(tmp_path / "b.h5")
    )
    with pytest.raises(ValueError):
        tdgl.solve(other, options2, seed_solution=sol)


def jittable_ramp_field(x, y, z, *, t, Bz_max, ramp_time):
    """A jax-traceable, time-dependent uniform-field vector potential."""
    import jax.numpy as jnp

    scale = jnp.clip(t / ramp_time, 0.0, 1.0)
    A = 0.5 * scale * Bz_max
    return jnp.stack([-A * y, A * x, jnp.zeros_like(jnp.asarray(x))], axis=1)


def host_ramp_field(x, y, z, *, t, Bz_max, ramp_time):
    """The same field, as a plain NumPy (host-evaluated) function."""
    scale = float(np.clip(t / ramp_time, 0.0, 1.0))
    A = 0.5 * scale * Bz_max
    return np.stack([-A * y, A * x, np.zeros_like(x)], axis=1)


def test_traced_vs_host_time_dependence(small_device, tmp_path):
    """The in-jit (traced) time-dependent A path must agree with the
    reference-style host-evaluated path.

    Uses a fixed dt and float64 over a short horizon: with adaptive retries,
    last-ulp differences between the two differently-compiled programs
    amplify chaotically into different dt branch choices (verified: the
    trajectories agree to ~1e-12 until a retry flips order).
    """
    kwargs = dict(Bz_max=0.05, ramp_time=0.3)  # mT
    traced = Parameter(jittable_ramp_field, time_dependent=True,
                       jittable=True, **kwargs)
    host = Parameter(host_ramp_field, time_dependent=True, **kwargs)
    solutions = {}
    for name, param in [("traced", traced), ("host", host)]:
        options = tdgl.SolverOptions(
            solve_time=0.5, dt_init=1e-3, dt_max=1e-3, save_every=100,
            field_units="mT", current_units="uA", dtype="float64",
            output_file=str(tmp_path / f"{name}.h5"),
        )
        solutions[name] = tdgl.solve(small_device, options,
                                     applied_vector_potential=param)
    psi_traced = np.asarray(solutions["traced"].tdgl_data.psi)
    psi_host = np.asarray(solutions["host"].tdgl_data.psi)
    assert len(solutions["traced"].dynamics.dt) == len(
        solutions["host"].dynamics.dt
    )
    assert np.max(np.abs(psi_traced - psi_host)) < 1e-8
    # The ramp actually did something.
    assert np.abs(psi_traced).min() < 0.99999


def test_composite_ramp_fast_path(small_device, tmp_path):
    """``ConstantField * LinearRamp`` is a fully-jittable composite, so the
    solver must take the compiled fast path (A evaluated in-jit, chunked
    stepping) and produce a ramped response."""
    from tdgl_tpu.solver.solver import TDGLSolver

    param = tdgl.sources.ConstantField(0.05) * tdgl.LinearRamp(
        tmin=0.0, tmax=0.3
    )
    assert param.jittable and param.time_dependent
    options = tdgl.SolverOptions(
        solve_time=0.5, dt_init=1e-3, dt_max=1e-3, save_every=100,
        field_units="mT", current_units="uA",
        output_file=str(tmp_path / "ramp.h5"),
    )
    solver = TDGLSolver(small_device, options, applied_vector_potential=param)
    assert solver._jittable_A  # fast path engaged
    assert solver.chunk_size > 1  # not forced into host-dynamic mode
    sol = solver.solve()
    assert np.abs(np.asarray(sol.tdgl_data.psi)).min() < 0.99999


def test_fixed_dt(small_device, tmp_path):
    options = tdgl.SolverOptions(
        solve_time=0.5, dt_init=1e-3, adaptive=False, save_every=100,
        output_file=str(tmp_path / "fixed.h5"),
    )
    sol = tdgl.solve(small_device, options, applied_vector_potential=0.01)
    dts = sol.dynamics.dt
    np.testing.assert_allclose(dts, 1e-3, rtol=1e-6)


def test_thermalization(small_device, tmp_path):
    options = tdgl.SolverOptions(
        solve_time=2, skip_time=1, dt_init=1e-4, save_every=100,
        output_file=str(tmp_path / "therm.h5"),
    )
    sol = tdgl.solve(small_device, options,
                     applied_vector_potential=tdgl.ConstantField(
                         30, field_units="uT"))
    # Recorded dynamics cover only the recording stage.
    assert sol.dynamics.time[-1] <= 2.5
    # The step-0 snapshot is the post-thermalization state, not psi=1.
    sol.solve_step = 0
    assert float(np.abs(np.asarray(sol.tdgl_data.psi)).min()) < 0.99999


def test_equal_physics_solvers_share_compiled_chunk(small_device):
    """Two solvers with identical physics (fresh but equal Parameter
    objects) must hit the compiled-chunk cache instead of recompiling —
    StepConfig keys on parameter fingerprints, not closure identity."""
    from tdgl_tpu.solver.solver import TDGLSolver
    from tdgl_tpu.solver.step import make_chunk_fn

    def make_solver():
        options = tdgl.SolverOptions(
            solve_time=5, dt_init=1e-4, save_every=100,
            field_units="uT", current_units="uA",
        )
        field = tdgl.ConstantField(
            10, field_units="uT", length_units="um"
        ) * tdgl.LinearRamp(tmin=0, tmax=4)
        return TDGLSolver(small_device, options,
                          applied_vector_potential=field)

    s1 = make_solver()
    s2 = make_solver()
    assert s1.cfg.A_fn is not s2.cfg.A_fn  # fresh closures...
    assert s1.cfg == s2.cfg                # ...that compare equal
    assert s1._raw_chunk_fn is s2._raw_chunk_fn  # cache hit: no recompile

    misses_before = make_chunk_fn.cache_info().misses
    s3 = make_solver()
    assert make_chunk_fn.cache_info().misses == misses_before
    assert s3._raw_chunk_fn is s1._raw_chunk_fn

    # A genuinely different field must NOT collide.
    options = tdgl.SolverOptions(
        solve_time=5, dt_init=1e-4, save_every=100,
        field_units="uT", current_units="uA",
    )
    field = tdgl.ConstantField(
        20, field_units="uT", length_units="um"
    ) * tdgl.LinearRamp(tmin=0, tmax=4)
    s4 = TDGLSolver(small_device, options, applied_vector_potential=field)
    assert s4.cfg != s1.cfg


def test_mg_poisson_solver_requires_structured_mesh(small_device):
    """poisson_solver='mg' on an unstructured mesh raises instead of
    silently downgrading to CG (the hex multigrid needs a lattice)."""
    from tdgl_tpu.solver.options import SolverOptionsError
    from tdgl_tpu.solver.solver import TDGLSolver

    options = tdgl.SolverOptions(
        solve_time=1, dt_init=1e-4, poisson_solver="mg",
        field_units="uT", current_units="uA",
    )
    with pytest.raises(SolverOptionsError, match="structured"):
        TDGLSolver(small_device, options)


def test_structured_mesh_rejects_unstructured_kwargs():
    """make_mesh(structured=True) rejects unstructured-mesher options
    instead of silently discarding them."""
    layer = tdgl.Layer(coherence_length=1.0, london_lambda=2, thickness=0.1)
    film = tdgl.Polygon("film", points=box(8)).resample(100)
    device = tdgl.Device("film", layer=layer, film=film)
    with pytest.raises(ValueError, match="smooth"):
        device.make_mesh(min_points=500, structured=True, smooth=10)
    with pytest.raises(ValueError, match="not applicable"):
        device.make_mesh(min_points=500, structured=True, max_volume=0.1)


def test_unstructured_solver_stays_on_default_device():
    """An unstructured (ELL) solve runs where jax puts it: its operators,
    preconditioner and state all live on ``jax.devices()[0]``."""
    from tdgl_tpu.solver.solver import TDGLSolver

    layer = tdgl.Layer(coherence_length=1.0, london_lambda=2, thickness=0.1)
    film = tdgl.Polygon("film", points=box(8)).resample(100)
    device = tdgl.Device("film", layer=layer, film=film)
    device.make_mesh(min_points=400)
    solver = TDGLSolver(device, tdgl.SolverOptions(solve_time=1,
                                                   save_every=5))
    assert not solver.structured
    state = solver._initial_state()
    home = jax.devices()[0]
    leaves = jax.tree.leaves((solver.op, solver.amg,
                              solver._screening_weights, state))
    assert leaves and all(leaf.devices() == {home} for leaf in leaves)
    state, _, _ = solver.chunk_fn(state)
    assert all(leaf.devices() == {home} for leaf in jax.tree.leaves(state))
