"""Steady-fast-chunk / chunk-level-failover semantics (SolverOptions.
chunk_failover) and the scan_unroll knob.

The fast program strips the per-step retry/top-up while_loops and flags
anomalies instead; the solver rewinds flagged chunks and re-runs them with
the robust program. Reference behavior being preserved: the retry loop of
``/root/reference/tdgl/solver/solver.py:441-487`` (a flagged psi step is
repaired by the robust rerun, never committed).
"""

import dataclasses

import numpy as np
import pytest

import tdgl_tpu as tdgl
from tdgl_tpu.geometry import box
from tdgl_tpu.utils.jaxio import to_numpy


def _device(size=8, edge=0.25):
    layer = tdgl.Layer(coherence_length=0.5, london_lambda=2,
                       thickness=0.05, conductivity=10.0)
    film = tdgl.Polygon("film", points=box(size)).resample(200)
    device = tdgl.Device("fo", layer=layer, film=film)
    device.make_mesh(structured=True, max_edge_length=edge)
    return device


def _solve(dtype, failover, **kw):
    options = tdgl.SolverOptions(
        solve_time=3, dt_init=1e-5, save_every=100, output_file=None,
        dtype=dtype, chunk_failover=failover, **kw,
    )
    solver = tdgl.TDGLSolver(_device(), options,
                             applied_vector_potential=0.4)
    solution = solver.solve()
    return solver, solution


def test_failover_f64_bitwise_vs_robust():
    """At f64 the mu solve is tolerance-stopped in both programs and any
    retry-worthy chunk fails over to the robust program, so the committed
    trajectory is IDENTICAL to chunk_failover='off'."""
    s_fast, sol_fast = _solve("float64", "auto")
    s_rob, sol_rob = _solve("float64", "off")
    assert hasattr(s_fast, "_fast_chunk_fn")
    assert not hasattr(s_rob, "_fast_chunk_fn")
    a, b = sol_fast.tdgl_data, sol_rob.tdgl_data
    assert np.array_equal(np.asarray(a.psi), np.asarray(b.psi))
    assert np.array_equal(np.asarray(a.mu), np.asarray(b.mu))


def test_failover_f32_cold_start_fires_then_fast():
    """The cold-start chunk trips a gate (dt ramp retries / cold mu) and
    fails over; the steady chunks run fast. Physics stays inside the
    validated mu-tolerance band vs the robust program."""
    s_fast, sol_fast = _solve("float32", "auto")
    s_rob, sol_rob = _solve("float32", "off")
    # The cold-start chunk fails over; the steady chunks (the run is many
    # chunks long) must not.
    assert 1 <= s_fast._failover_count <= 3
    a = np.abs(np.asarray(sol_fast.tdgl_data.psi))
    b = np.abs(np.asarray(sol_rob.tdgl_data.psi))
    assert float(np.max(np.abs(a - b))) < 1e-3


def test_fast_chunk_accepts_only_gated_steps():
    """Directly run the fast program on a steady state: accepted chunks
    report no failure and execute every step."""
    s, _ = _solve("float32", "auto")
    import jax.numpy as jnp

    # Reach a steady state by advancing a few chunks through the
    # failover wrapper, then drive the fast program directly.
    state = s._initial_state()._replace(
        end_time=jnp.asarray(1e9, s.rdtype))
    for _ in range(3):
        state, _, _ = s.chunk_fn(state)
    out_state, outputs, exported = s._fast_chunk_fn(
        s.sten, s._screening_weights, s.amg, state)
    diag = to_numpy(exported["diagnostics"])
    assert not bool(diag[5])
    assert int(np.sum(to_numpy(outputs.valid))) == s.chunk_size


def test_failover_screened_bitwise_vs_robust():
    """With screening, the fast program runs ONE inline fixed-point
    iteration (bitwise-identical to the while_loop executing once) and
    fails over whenever a step needs more — so with the fast program's
    cheap-approximation knobs pinned to the robust values, the committed
    screened trajectory is IDENTICAL to chunk_failover='off'."""
    kw = dict(include_screening=True, screening_tolerance=1e-2,
              screening_fast_iterations=5, scan_unroll=1,
              screening_site_eval=False)
    s_fast, sol_fast = _solve("float32", "auto", **kw)
    s_rob, sol_rob = _solve("float32", "off", **kw)
    assert hasattr(s_fast, "_fast_chunk_fn")
    assert s_fast.cfg.include_screening
    a, b = sol_fast.tdgl_data, sol_rob.tdgl_data
    assert np.array_equal(np.asarray(a.psi), np.asarray(b.psi))
    assert np.array_equal(np.asarray(a.mu), np.asarray(b.mu))
    assert np.array_equal(np.asarray(a.induced_vector_potential),
                          np.asarray(b.induced_vector_potential))


def test_failover_screened_auto_fast_config():
    """The auto fast screened program runs the measured-best cheap
    configuration (scan unroll 2, 3 inner fixed iterations, the
    site-evaluated convolution) while the robust rewind
    program keeps the deep/exact settings — and its committed physics
    stays within the gate tolerances of the robust trajectory."""
    kw = dict(include_screening=True, screening_tolerance=1e-2)
    s_fast, sol_fast = _solve("float32", "auto", **kw)
    s_rob, sol_rob = _solve("float32", "off", **kw)
    fast_cfg = s_fast._fast_cfg
    assert fast_cfg.scan_unroll == 2
    assert fast_cfg.screening_cg_iters == 3
    # Site-evaluated interpolated convolution in the fast program only
    # (with its static near-field correction stencils baked in).
    assert fast_cfg.screening_site_eval
    assert len(fast_cfg.screening_site_taps) == 3
    # Robust program untouched: deep inner count and the exact
    # per-edge-class convolution.
    assert s_fast.cfg.screening_cg_iters == 5
    assert not s_fast.cfg.screening_site_eval
    a = np.abs(np.asarray(sol_fast.tdgl_data.psi))
    b = np.abs(np.asarray(sol_rob.tdgl_data.psi))
    assert float(np.max(np.abs(a - b))) < 1e-2


def test_screened_fast_mu_gate_follows_fail_gate():
    """The screened fast program gates its mu residual at
    ``poisson_fail_gate`` (chunk-rewind semantics, mirroring the
    unscreened branch) — NOT at ``poisson_tolerance``. Discriminating
    construction at f64 (residual floors ~1e-14): a fixed-1 mu solve
    against an absurd 1e-12 tolerance leaves a residual far above
    tolerance, so the old tolerance-pinned gate would flag every step;
    a loose fail gate must accept the chunk, and a fail gate below the
    achievable residual must flag it."""
    import jax.numpy as jnp

    kw = dict(include_screening=True, screening_tolerance=1e-2,
              screening_fast_iterations=5, scan_unroll=1,
              screening_site_eval=False)
    s, _ = _solve("float64", "auto", **kw)
    from tdgl_tpu.solver.grid_step import make_grid_chunk_fn

    state = s._initial_state()._replace(
        end_time=jnp.asarray(1e9, s.rdtype))
    for _ in range(3):
        state, _, _ = s.chunk_fn(state)

    def run_gate(fail_gate):
        cfg = dataclasses.replace(
            s._fast_cfg, poisson_fixed_iters=1,
            poisson_tolerance=1e-12, poisson_fail_gate=fail_gate,
        )
        fn = make_grid_chunk_fn(cfg, s.chunk_size)
        _, _, exported = fn(s.sten, s._screening_weights, s.amg, state)
        return bool(to_numpy(exported["diagnostics"])[5])

    # Loose gate: one V-cycle cannot reach 1e-12, but the fast program
    # judges it against the fail gate, so the chunk commits cleanly.
    assert not run_gate(1.0)
    # A gate below the fixed-1 residual floor flags the chunk (the same
    # plumbing that triggers the solver's rewind to the robust program).
    assert run_gate(1e-13)


def test_failover_on_requires_supported_mode():
    # The fast-chunk program exists only on the structured backend.
    layer = tdgl.Layer(coherence_length=0.5, london_lambda=2,
                       thickness=0.05, conductivity=10.0)
    film = tdgl.Polygon("film", points=box(6)).resample(100)
    device = tdgl.Device("un", layer=layer, film=film)
    device.make_mesh(min_points=400)
    options = tdgl.SolverOptions(
        solve_time=1, output_file=None, chunk_failover="on",
    )
    with pytest.raises(Exception, match="chunk_failover"):
        tdgl.TDGLSolver(device, options, applied_vector_potential=0.4)


def test_failover_option_validation():
    with pytest.raises(Exception, match="chunk_failover"):
        tdgl.SolverOptions(solve_time=1, chunk_failover="maybe").validate()
    with pytest.raises(Exception, match="scan_unroll"):
        tdgl.SolverOptions(solve_time=1, scan_unroll=0).validate()


def test_scan_unroll_trajectory_invariant():
    """scan_unroll is pure scheduling: the committed trajectory is
    identical (CPU: bitwise) across unroll factors."""
    _, sol1 = _solve("float32", "off", scan_unroll=1)
    _, sol2 = _solve("float32", "off", scan_unroll=2)
    assert np.array_equal(np.asarray(sol1.tdgl_data.psi),
                          np.asarray(sol2.tdgl_data.psi))
    assert np.array_equal(np.asarray(sol1.tdgl_data.mu),
                          np.asarray(sol2.tdgl_data.mu))


def test_fast_cfg_gate_value():
    # Unscreened auto f32: the fast program runs the gated fixed-1 mu
    # solve with the validated 1e-2 fail gate (round 5; the robust
    # rewind program keeps fixed-2 + top-up at the 1e-4 auto tolerance).
    s, _ = _solve("float32", "auto")
    assert s._fast_cfg.fast_chunk
    assert s._fast_cfg.poisson_fixed_iters == 1
    assert s.cfg.poisson_fixed_iters == 2
    assert s._fast_cfg.poisson_fail_gate == pytest.approx(1e-2)
    # An explicit tolerance opts out of the fixed-1 override: the gate
    # follows 10x the requested tolerance and the fixed count is the
    # auto fixed-2.
    s2, _ = _solve("float32", "auto", poisson_tolerance=1e-4)
    assert s2._fast_cfg.poisson_fixed_iters == 2
    assert s2._fast_cfg.poisson_fail_gate == pytest.approx(
        10.0 * s2.cfg.poisson_tolerance)
