"""Parity of the hex-grid stencil backend against the ELL backend.

Both backends discretize the same equations on the same structured mesh, so
every operator must agree to rounding. The ELL forms are themselves verified
against SciPy sparse matrices in ``test_operators.py``, making this a full
chain back to the textbook definitions.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import tdgl_tpu as tdgl
from tdgl_tpu.fv.operators import build_operators
from tdgl_tpu.fv.stencil_operators import build_stencil_operators
from tdgl_tpu.geometry import box, circle
from tdgl_tpu.models import gtdgl, gtdgl_stencil


@pytest.fixture(scope="module")
def structured_device():
    layer = tdgl.Layer(coherence_length=0.5, london_lambda=2,
                       thickness=0.05, conductivity=10.0)
    film = tdgl.Polygon("film", points=box(8)).resample(200)
    hole = tdgl.Polygon("hole", points=circle(1.0, center=(1.5, 1.5)))
    device = tdgl.Device("stenc", layer=layer, film=film, holes=[hole])
    device.make_mesh(min_points=2500, structured=True)
    return device


@pytest.fixture(scope="module")
def backends(structured_device):
    mesh = structured_device.mesh
    rng = np.random.default_rng(7)
    # A few synthetic terminal (fixed) sites on the boundary.
    fixed = np.asarray(mesh.boundary_indices[:7], dtype=np.int32)
    op = build_operators(mesh, fixed_sites=fixed, dtype=np.float64)
    sten, maps = build_stencil_operators(mesh, fixed_sites=fixed,
                                         dtype=np.float64)
    return mesh, op, sten, maps, rng


def test_grid_maps_roundtrip(backends):
    mesh, op, sten, maps, rng = backends
    v = rng.normal(size=maps.n_sites)
    assert np.array_equal(maps.grid_to_site(maps.site_to_grid(v)), v)
    e = rng.normal(size=(maps.n_edges, 2))
    assert np.array_equal(maps.grid_to_edge(maps.edge_to_grid(e)), e)


def test_geometry_tables_match(backends):
    mesh, op, sten, maps, rng = backends
    assert np.allclose(maps.grid_to_site(np.asarray(sten.area)), op.areas)
    assert np.allclose(
        maps.grid_to_edge(np.asarray(sten.w).reshape(3, *maps.shape)),
        op.dual_edge_lengths / op.edge_lengths,
    )
    # Class direction vectors match the actual mesh edge directions.
    k = mesh.grid.edge_krc[:, 0]
    dirs = np.asarray(mesh.edge_mesh.directions)
    assert np.allclose(dirs, np.asarray(sten.edge_dirs)[k], atol=1e-8)


def test_scalar_laplacian_parity(backends):
    mesh, op, sten, maps, rng = backends
    x = rng.normal(size=maps.n_sites)
    want = np.asarray(gtdgl.scalar_laplacian_sym(op, x))
    got_grid = gtdgl_stencil.scalar_laplacian_sym(
        sten, maps.site_to_grid(x)
    )
    got = maps.grid_to_site(np.asarray(got_grid))
    assert np.allclose(got, want, atol=1e-10)


def test_gradient_and_supercurrent_parity(backends):
    mesh, op, sten, maps, rng = backends
    x = rng.normal(size=maps.n_sites)
    want = np.asarray(gtdgl.gradient_on_edges(op, x))
    got = maps.grid_to_edge(
        np.asarray(gtdgl_stencil.gradient_on_edges(sten,
                                                   maps.site_to_grid(x)))
    )
    assert np.allclose(got, want, atol=1e-10)

    A = rng.normal(size=(maps.n_edges, 2)) * 0.3
    psi = rng.normal(size=maps.n_sites) + 1j * rng.normal(size=maps.n_sites)
    U = gtdgl.edge_link_phases(A, op.edge_directions)
    want_J = np.asarray(
        gtdgl.supercurrent_on_edges(op, U, gtdgl.pack(jnp.asarray(psi)))
    )

    A_grid = maps.edge_to_grid(A)
    U = gtdgl_stencil.edge_link_phases(sten, A_grid)
    got_J = maps.grid_to_edge(np.asarray(
        gtdgl_stencil.supercurrent_on_edges(
            sten, U,
            maps.site_to_grid(psi.real), maps.site_to_grid(psi.imag),
        )
    ))
    assert np.allclose(got_J, want_J, atol=1e-10)


def test_covariant_laplacian_parity(backends):
    mesh, op, sten, maps, rng = backends
    A = rng.normal(size=(maps.n_edges, 2)) * 0.3
    psi = rng.normal(size=maps.n_sites) + 1j * rng.normal(size=maps.n_sites)
    U = gtdgl.edge_link_phases(A, op.edge_directions)
    want = np.asarray(gtdgl.unpack(
        gtdgl.covariant_laplacian(op, U, gtdgl.pack(jnp.asarray(psi)))
    ))

    U = gtdgl_stencil.edge_link_phases(sten, maps.edge_to_grid(A))
    lr, li = gtdgl_stencil.covariant_laplacian(
        sten, U,
        maps.site_to_grid(psi.real), maps.site_to_grid(psi.imag),
    )
    got = maps.grid_to_site(np.asarray(lr)) + 1j * maps.grid_to_site(
        np.asarray(li)
    )
    assert np.allclose(got, want, atol=1e-10)


def test_divergence_and_site_average_parity(backends):
    mesh, op, sten, maps, rng = backends
    F = rng.normal(size=maps.n_edges)
    want = np.asarray(gtdgl.divergence_on_sites(op, F))
    got = maps.grid_to_site(np.asarray(
        gtdgl_stencil.divergence_on_sites(sten, maps.edge_to_grid(F))
    ))
    assert np.allclose(got, want, atol=1e-10)

    want_site = np.asarray(
        gtdgl.edge_quantity_to_sites(op, F, maps.n_sites)
    )
    got_site = maps.grid_to_site(np.asarray(
        gtdgl_stencil.edge_quantity_to_sites(sten, maps.edge_to_grid(F))
    ))
    assert np.allclose(got_site, want_site, atol=1e-10)


def test_neumann_term_parity(backends):
    mesh, op, sten, maps, rng = backends
    mu_b = rng.normal(size=len(op.boundary_edge_indices))
    want = np.asarray(
        gtdgl.neumann_boundary_term(op, mu_b, maps.n_sites)
    )
    got = maps.grid_to_site(np.asarray(
        gtdgl_stencil.neumann_boundary_term(sten, mu_b)
    ))
    assert np.allclose(got, want, atol=1e-10)
    # Boundary-edge ordering matches between the two backends (the host
    # computes mu_boundary in ELL boundary-edge order).
    assert np.array_equal(op.boundary_edge_indices,
                          np.asarray(mesh.edge_mesh.boundary_edge_indices))


def test_implicit_euler_parity(backends):
    mesh, op, sten, maps, rng = backends
    A = rng.normal(size=(maps.n_edges, 2)) * 0.2
    psi = (rng.normal(size=maps.n_sites)
           + 1j * rng.normal(size=maps.n_sites)) * 0.5
    sq = np.abs(psi) ** 2
    mu = rng.normal(size=maps.n_sites)
    eps = np.ones(maps.n_sites)
    gamma, u, dt = 10.0, 5.79, 1e-3

    U = gtdgl.edge_link_phases(A, op.edge_directions)
    want = gtdgl.implicit_euler_psi(op, U, gtdgl.pack(jnp.asarray(psi)), sq,
                                    mu, eps, gamma, u, dt)

    U = gtdgl_stencil.edge_link_phases(sten, maps.edge_to_grid(A))
    got = gtdgl_stencil.implicit_euler_psi(
        sten, U,
        maps.site_to_grid(psi.real), maps.site_to_grid(psi.imag),
        maps.site_to_grid(sq), maps.site_to_grid(mu),
        maps.site_to_grid(eps), gamma, u, dt,
    )
    got_psi = (maps.grid_to_site(np.asarray(got.psi_r))
               + 1j * maps.grid_to_site(np.asarray(got.psi_i)))
    assert bool(got.ok) == bool(want.ok)
    assert np.allclose(got_psi, np.asarray(gtdgl.unpack(want.psi)),
                       atol=1e-10)
    assert np.allclose(maps.grid_to_site(np.asarray(got.abs_sq_psi)),
                       np.asarray(want.abs_sq_psi), atol=1e-10)


# ---------------------------------------------------------------------------
# End-to-end backend parity: same structured mesh, ELL vs stencil solver.
# ---------------------------------------------------------------------------

def _trajectory(device, backend, steps=400, dt=1e-3, field=0.5,
                currents=None, **solver_kwargs):
    import tdgl_tpu as tdgl
    from tdgl_tpu.solver.solver import TDGLSolver
    from tdgl_tpu.utils.jaxio import tree_to_numpy

    options = tdgl.SolverOptions(
        solve_time=1e9,             # run by step count
        dt_init=dt,
        adaptive=False,
        save_every=steps,
        dtype="float64",
        solver_backend=backend,
        field_units="mT",
        current_units="uA",
        # Tight mu solves so backend differences in CG stopping points do
        # not mask discretization parity.
        poisson_tolerance=1e-11,
    )
    solver = TDGLSolver(device, options,
                        applied_vector_potential=field,
                        terminal_currents=currents, **solver_kwargs)
    state = solver._initial_state()
    n_chunks = steps // solver.chunk_size
    for _ in range(n_chunks):
        state, outputs, exported = solver.chunk_fn(state)
    data = solver._state_to_arrays(tree_to_numpy(exported))
    diag = tree_to_numpy(exported)["diagnostics"]
    assert not bool(diag[5]), f"{backend} solver failed"
    return data


def test_backend_trajectory_parity(structured_device):
    """ELL and stencil backends produce identical trajectories (fixed dt,
    float64) on the same structured mesh: the two data layouts encode the
    same discrete equations."""
    a = _trajectory(structured_device, "ell")
    b = _trajectory(structured_device, "stencil")
    scale = np.abs(a["psi"]).max()
    assert np.abs(a["psi"] - b["psi"]).max() / scale < 1e-9
    mu_scale = max(np.abs(a["mu"]).max(), 1e-12)
    assert np.abs(a["mu"] - b["mu"]).max() / mu_scale < 1e-7
    assert np.allclose(a["supercurrent"], b["supercurrent"], atol=1e-9)
    assert np.allclose(a["normal_current"], b["normal_current"], atol=1e-9)


def test_backend_transport_parity():
    """Terminal-current (Neumann BC) handling matches between backends."""
    import tdgl_tpu as tdgl
    from tdgl_tpu.geometry import box

    xi = 1.0
    layer = tdgl.Layer(coherence_length=xi, london_lambda=2, thickness=0.1)
    film = tdgl.Polygon("film", points=box(16, 6)).resample(300)
    # NOTE: on a staircase (structured) mesh, boundary sites sit up to one
    # lattice spacing inside the polygon edge, so terminal polygons must be
    # wide enough to overlap them (here 1.5 >> h).
    source = tdgl.Polygon(points=box(1.5, 6, center=(-8, 0))).set_name(
        "source"
    )
    drain = source.copy().scale(xfact=-1).set_name("drain")
    device = tdgl.Device(
        "bar", layer=layer, film=film, terminals=[source, drain],
        probe_points=[(-6, 0), (6, 0)], length_units="um",
    )
    device.make_mesh(min_points=1800, structured=True)
    currents = dict(source=3.0, drain=-3.0)
    a = _trajectory(device, "ell", steps=300, field=0.0, currents=currents)
    b = _trajectory(device, "stencil", steps=300, field=0.0,
                    currents=currents)
    scale = np.abs(a["psi"]).max()
    assert np.abs(a["psi"] - b["psi"]).max() / scale < 1e-9
    mu_scale = max(np.abs(a["mu"]).max(), 1e-12)
    assert np.abs(a["mu"] - b["mu"]).max() / mu_scale < 1e-7


def test_traced_currents_grid_parity():
    """On the stencil backend, a jittable terminal-current ramp (traced
    inside the compiled chunk, chunk size > 1) produces the same trajectory
    as the host path (chunk size 1, currents evaluated in Python every
    step)."""
    import jax.numpy as jnp

    import tdgl_tpu as tdgl
    from tdgl_tpu.geometry import box
    from tdgl_tpu.solver.solver import TDGLSolver

    xi = 1.0
    layer = tdgl.Layer(coherence_length=xi, london_lambda=2, thickness=0.1)
    film = tdgl.Polygon("film", points=box(16, 6)).resample(300)
    source = tdgl.Polygon(points=box(1.5, 6, center=(-8, 0))).set_name(
        "source"
    )
    drain = source.copy().scale(xfact=-1).set_name("drain")
    device = tdgl.Device(
        "bar", layer=layer, film=film, terminals=[source, drain],
        probe_points=[(-6, 0), (6, 0)], length_units="um",
    )
    device.make_mesh(min_points=1800, structured=True)

    @tdgl.jittable
    def ramp_traced(t):
        bias = 1.0 + 2.0 * jnp.minimum(t * 5.0, 1.0)
        return dict(source=bias, drain=-bias)

    def ramp_host(t):
        bias = 1.0 + 2.0 * min(float(t) * 5.0, 1.0)
        return dict(source=bias, drain=-bias)

    a = _trajectory(device, "stencil", steps=200,
                    field=0.0, currents=ramp_traced)

    # Host path: chunk size 1 with the host-update callback applied before
    # every step, exactly as the Runner drives it.
    from tdgl_tpu.utils.jaxio import tree_to_numpy

    options_host = tdgl.SolverOptions(
        solve_time=1e9, dt_init=1e-3, adaptive=False, save_every=200,
        dtype="float64", solver_backend="stencil",
        field_units="mT", current_units="uA", poisson_tolerance=1e-11,
    )
    solver_b = TDGLSolver(device, options_host,
                          terminal_currents=ramp_host)
    assert solver_b.chunk_size == 1
    state = solver_b._initial_state()
    for _ in range(200):
        state = solver_b._host_update(state)
        state, _, exported = solver_b.chunk_fn(state)
    b = solver_b._state_to_arrays(tree_to_numpy(exported))

    # chunk-size check: the traced solver fuses steps, the host one cannot.
    options = tdgl.SolverOptions(
        solve_time=1.0, save_every=100, dtype="float64",
        solver_backend="stencil", field_units="mT", current_units="uA",
    )
    assert TDGLSolver(device, options,
                      terminal_currents=ramp_traced).chunk_size > 1
    assert TDGLSolver(device, options,
                      terminal_currents=ramp_host).chunk_size == 1
    scale = np.abs(a["psi"]).max()
    assert np.abs(a["psi"] - b["psi"]).max() / scale < 1e-9
    mu_scale = max(np.abs(a["mu"]).max(), 1e-12)
    assert np.abs(a["mu"] - b["mu"]).max() / mu_scale < 1e-7


def test_fft_screening_parity(structured_device):
    """The lattice FFT convolution reproduces the O(E x S) pairwise sum
    exactly (same positions, same weights) to f32 rounding."""
    import jax
    import jax.numpy as jnp

    from tdgl_tpu.ops.fft_screening import (build_fft_screening,
                                            induced_vector_potential_fft)
    from tdgl_tpu.ops.screening import induced_vector_potential

    mesh = structured_device.mesh
    sten, maps = build_stencil_operators(mesh, dtype=np.float32)
    sten_j = jax.tree.map(jnp.asarray, sten)
    fftd = build_fft_screening(sten, maps, mesh.grid)
    rng = np.random.default_rng(5)
    Jw = (rng.normal(size=maps.shape + (2,)).astype(np.float32)
          * np.asarray(sten.valid)[..., None])

    A_fft = np.asarray(
        induced_vector_potential_fft(fftd, sten_j, jnp.asarray(Jw))
    )
    far = 1e6 * (1.0 - np.asarray(sten.valid))
    sites_xy = np.stack([np.asarray(sten.site_x) + far,
                         np.asarray(sten.site_y) + far], -1).reshape(-1, 2)
    ec_xy = np.stack([np.asarray(sten.ec_x),
                      np.asarray(sten.ec_y)], -1).reshape(-1, 2)
    A_ref = np.asarray(induced_vector_potential(
        jnp.asarray(ec_xy), jnp.asarray(sites_xy),
        jnp.asarray(Jw.reshape(-1, 2)),
    )).reshape(3, *maps.shape, 2) * np.asarray(sten.edge_valid)[..., None]
    scale = np.abs(A_ref).max()
    assert np.abs(A_fft - A_ref).max() / scale < 1e-5


def test_structured_screened_solve():
    """End-to-end screened solve on the structured backend (FFT kernel,
    float32): converges every step (completion implies the tolerance gate
    passed) and produces diamagnetic screening currents."""
    import tdgl_tpu as tdgl

    xi = 0.1
    layer = tdgl.Layer(coherence_length=xi, london_lambda=0.075,
                       thickness=0.05)
    film = tdgl.Polygon("film", points=box(1, 0.5, points=151))
    device = tdgl.Device("sbar", layer=layer, film=film, length_units="um")
    device.make_mesh(max_edge_length=xi / 1.5, structured=True)
    options = tdgl.SolverOptions(
        solve_time=0.5,
        dt_max=1e-3,
        field_units="mT",
        current_units="uA",
        include_screening=True,
        screening_tolerance=1e-3,
        dtype="float32",
    )
    sol = tdgl.solve(device, options, applied_vector_potential=0.1)
    A_ind = sol.tdgl_data.induced_vector_potential
    assert np.linalg.norm(A_ind, axis=1).max() > 0
    # Diamagnetic: the induced moment opposes the applied field.
    m = sol.magnetic_moment().magnitude
    assert m < 0


def test_backend_screened_trajectory_parity():
    """Screened dynamics match between backends on the same structured mesh
    (fixed dt, float64): the ELL path sums the O(E x S) pairwise kernel,
    the stencil path evaluates the exact FFT convolution — same physics,
    same trajectory."""
    import tdgl_tpu as tdgl

    xi = 0.2
    layer = tdgl.Layer(coherence_length=xi, london_lambda=0.15,
                       thickness=0.05)
    film = tdgl.Polygon("film", points=box(1, 0.6, points=101))
    device = tdgl.Device("spar", layer=layer, film=film, length_units="um")
    device.make_mesh(max_edge_length=xi / 1.2, structured=True)

    def run(backend):
        from tdgl_tpu.solver.solver import TDGLSolver
        from tdgl_tpu.utils.jaxio import tree_to_numpy

        options = tdgl.SolverOptions(
            solve_time=1e9,
            dt_init=5e-4,
            adaptive=False,
            save_every=100,
            dtype="float64",
            solver_backend=backend,
            field_units="mT",
            current_units="uA",
            include_screening=True,
            screening_tolerance=1e-7,
            poisson_tolerance=1e-11,
            # Deep fixed inner solves: the two backends use different
            # preconditioners, so a small fixed count leaves
            # backend-dependent residuals that mask discretization parity.
            screening_cg_iterations=40,
        )
        solver = TDGLSolver(device, options, applied_vector_potential=0.05)
        state = solver._initial_state()
        for _ in range(2):
            state, outputs, exported = solver.chunk_fn(state)
        data = solver._state_to_arrays(tree_to_numpy(exported))
        diag = tree_to_numpy(exported)["diagnostics"]
        assert not bool(diag[5]), f"{backend} screened solver failed"
        return data

    a = run("ell")
    b = run("stencil")
    scale = np.abs(a["psi"]).max()
    assert np.abs(a["psi"] - b["psi"]).max() / scale < 1e-6
    A_scale = np.linalg.norm(a["induced_vector_potential"], axis=1).max()
    assert A_scale > 0
    dA = np.linalg.norm(
        a["induced_vector_potential"] - b["induced_vector_potential"],
        axis=1,
    ).max()
    assert dA / A_scale < 1e-5


def test_fft_screening_matches_pairwise_float64():
    """The FFT lattice convolution equals the plain pairwise sum
    ``A[e] = sum_s Jw[s] / |r_e - r_s|`` over every (edge, site) pair,
    evaluated in float64 NumPy from the padded grid's own coordinates."""
    import jax.numpy as jnp

    import tdgl_tpu as tdgl
    from tdgl_tpu.geometry import box
    from tdgl_tpu.ops.fft_screening import (
        build_fft_screening,
        induced_vector_potential_fft,
    )
    from tdgl_tpu.solver.solver import TDGLSolver

    layer = tdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                       thickness=0.1)
    film = tdgl.Polygon("film", points=box(6)).resample(60)
    device = tdgl.Device("pair", layer=layer, film=film, length_units="um")
    device.make_mesh(min_points=400, structured=True)
    options = tdgl.SolverOptions(
        solve_time=1.0, include_screening=True, dtype="float64",
        field_units="mT", current_units="uA",
    )
    solver = TDGLSolver(device, options, applied_vector_potential=0.5)
    sten = solver.host_sten
    fftd = build_fft_screening(sten, solver.maps, device.mesh.grid,
                               dtype=np.float64)
    valid = np.asarray(sten.valid) > 0
    rng = np.random.default_rng(3)
    J = rng.standard_normal(solver.maps.shape + (2,)) * valid[..., None]
    A = np.asarray(induced_vector_potential_fft(fftd, solver.sten,
                                                jnp.asarray(J)))
    sites = np.stack([np.asarray(sten.site_x)[valid],
                      np.asarray(sten.site_y)[valid]], -1)
    edge_valid = np.asarray(sten.edge_valid) > 0
    ec = np.stack([np.asarray(sten.ec_x)[edge_valid],
                   np.asarray(sten.ec_y)[edge_valid]], -1)
    dist = np.linalg.norm(ec[:, None, :] - sites[None, :, :], axis=-1)
    ref = (1.0 / dist) @ J[valid]
    got = A[edge_valid]
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


def test_site_eval_screening_accuracy():
    """The site-evaluated interpolated convolution (the fast chunk
    program's auto default at f32): (a) for a smooth current the residual
    vs the exact per-edge-class convolution sits at the float32 screening
    precision floor (~3e-4), (b) a locally constant current is reproduced
    to the same order (moment matching)."""
    import jax.numpy as jnp

    import tdgl_tpu as tdgl
    from tdgl_tpu.geometry import box
    from tdgl_tpu.ops.fft_screening import (
        build_fft_screening,
        build_site_interp_taps,
        induced_vector_potential_fft,
        induced_vector_potential_fft_site,
    )
    from tdgl_tpu.solver.solver import TDGLSolver

    layer = tdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                       thickness=0.1)
    film = tdgl.Polygon("film", points=box(10)).resample(100)
    device = tdgl.Device("site", layer=layer, film=film, length_units="um")
    device.make_mesh(min_points=2000, structured=True)
    options = tdgl.SolverOptions(
        solve_time=1.0, include_screening=True,
        field_units="mT", current_units="uA",
    )
    solver = TDGLSolver(device, options, applied_vector_potential=0.5)
    fftd = build_fft_screening(solver.host_sten, solver.maps,
                               device.mesh.grid)
    taps = build_site_interp_taps(solver.host_sten, solver.maps,
                                  device.mesh.grid)
    assert taps is not None and len(taps) == 3
    valid = np.asarray(solver.host_sten.valid)
    Rp, Cp = solver.maps.shape
    yy, xx = np.mgrid[0:Rp, 0:Cp]
    J = np.stack(
        [np.sin(2 * np.pi * xx / Cp) * np.cos(2 * np.pi * yy / Rp),
         np.cos(4 * np.pi * xx / Cp) * np.sin(2 * np.pi * yy / Rp)], -1)
    Jw = jnp.asarray((J * valid[..., None]).astype(np.float32))
    A_exact = induced_vector_potential_fft(fftd, solver.sten, Jw)
    A_site = induced_vector_potential_fft_site(fftd, solver.sten, Jw, taps)
    scale = float(jnp.abs(A_exact).max())
    assert float(jnp.abs(A_site - A_exact).max()) / scale < 1e-3
    Jc = jnp.asarray((np.ones((Rp, Cp, 2)) * valid[..., None])
                     .astype(np.float32))
    Ac_exact = induced_vector_potential_fft(fftd, solver.sten, Jc)
    Ac_site = induced_vector_potential_fft_site(fftd, solver.sten, Jc,
                                                taps)
    sc = float(jnp.abs(Ac_exact).max())
    assert float(jnp.abs(Ac_site - Ac_exact).max()) / sc < 1e-3


def test_folded_link_weights_trajectory_parity():
    """fold_link_weights (the f32 auto default) tracks the unfolded
    formulation to f32 rounding over a chunked trajectory, and bf16 link
    storage (opt-in) stays within its documented ~1e-2 envelope."""
    import tdgl_tpu as tdgl
    from tdgl_tpu.geometry import box
    from tdgl_tpu.solver.solver import TDGLSolver
    from tdgl_tpu.utils.jaxio import to_numpy

    layer = tdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                       thickness=0.1)
    film = tdgl.Polygon("film", points=box(10)).resample(100)
    device = tdgl.Device("fold", layer=layer, film=film, length_units="um")
    device.make_mesh(min_points=2000, structured=True)

    def run(**kw):
        options = tdgl.SolverOptions(
            solve_time=1e9, dt_init=1e-3, adaptive=False,
            save_every=100, steps_per_chunk=100, dtype="float32",
            field_units="mT", current_units="uA", **kw)
        solver = TDGLSolver(device, options, applied_vector_potential=0.5)
        state = solver._initial_state()
        for _ in range(2):
            state, _, _ = solver.chunk_fn(state)
        return to_numpy(state.psi_r)

    base = run(fold_link_weights=False, factor_link_phases=False)
    folded = run(factor_link_phases=False)  # auto: folded on at f32
    bf16 = run(link_phase_bf16=True, factor_link_phases=False)
    scale = np.abs(base).max()
    assert np.abs(folded - base).max() / scale < 1e-3
    assert np.abs(bf16 - base).max() / scale < 3e-2


def test_factored_link_phases():
    """The rank-structured link-phase path (auto default for f32 static
    uniform fields): (a) the reconstructed link planes match the direct
    cos/sin evaluation at every real edge, (b) a chunked trajectory tracks
    the plane-based formulation to f32 rounding, and (c) non-separable
    potentials fall back (auto) or raise (explicit)."""
    import jax
    import tdgl_tpu as tdgl
    from tdgl_tpu.geometry import box
    from tdgl_tpu.models import gtdgl_stencil as gs
    from tdgl_tpu.solver.solver import TDGLSolver
    from tdgl_tpu.solver.options import SolverOptionsError
    from tdgl_tpu.utils.jaxio import to_numpy

    layer = tdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                       thickness=0.1)
    film = tdgl.Polygon("film", points=box(10)).resample(100)
    device = tdgl.Device("fact", layer=layer, film=film, length_units="um")
    device.make_mesh(min_points=2000, structured=True)

    def make(**kw):
        options = tdgl.SolverOptions(
            solve_time=1e9, dt_init=1e-3, adaptive=False,
            save_every=100, steps_per_chunk=100, dtype="float32",
            field_units="mT", current_units="uA", **kw)
        return TDGLSolver(device, options, applied_vector_potential=0.5)

    # (a) plane-level parity at real edges.
    solver = make()
    assert solver.cfg.factor_link_phases  # auto-on for uniform fields
    state = solver._initial_state()
    fact = gs.factor_link_phases(solver.sten, state.A_applied)
    direct = gs.edge_link_phases(solver.sten, state.A_applied)
    ev = np.asarray(solver.host_sten.edge_valid) > 0
    for k in range(3):
        ur, ui = gs._factored_u_k(fact, k, jnp.float32)
        assert np.abs(
            np.asarray(ur) - np.asarray(direct.ur[k])
        )[ev[k]].max() < 5e-6
        assert np.abs(
            np.asarray(ui) - np.asarray(direct.ui[k])
        )[ev[k]].max() < 5e-6

    # (b) trajectory parity vs the folded-plane formulation.
    def run(solver):
        state = solver._initial_state()
        for _ in range(2):
            state, _, _ = solver.chunk_fn(state)
        return to_numpy(state.psi_r)

    base = run(make(factor_link_phases=False))
    fac = run(make())
    scale = np.abs(base).max()
    assert np.abs(fac - base).max() / scale < 1e-3

    # (c) non-separable potential: auto falls back, explicit True raises.
    def radial_A(x, y, z):
        r2 = x**2 + y**2
        return np.stack([-y * r2, x * r2, np.zeros_like(x)], axis=-1)

    options = tdgl.SolverOptions(
        solve_time=1e9, dt_init=1e-3, adaptive=False, save_every=100,
        steps_per_chunk=100, dtype="float32", field_units="mT",
        current_units="uA")
    s_auto = TDGLSolver(device, options, applied_vector_potential=radial_A)
    assert not s_auto.cfg.factor_link_phases
    with pytest.raises(SolverOptionsError, match="separable"):
        TDGLSolver(
            device,
            tdgl.SolverOptions(
                solve_time=1e9, dt_init=1e-3, adaptive=False,
                save_every=100, steps_per_chunk=100, dtype="float32",
                field_units="mT", current_units="uA",
                factor_link_phases=True),
            applied_vector_potential=radial_A,
        )
