"""Test configuration.

Tests run on a virtual 8-device CPU mesh so that multi-device sharding code
paths are exercised without accelerator hardware. Set platform/flags BEFORE
jax is imported anywhere. Tests marked ``gpu`` need the card and skip on
the CPU (see the ``gpu_device`` fixture).
"""

import os

# TDGL_TEST_GPU=1 leaves the platform to jax, so that the ``gpu`` tests run
# on the card: ``TDGL_TEST_GPU=1 python -m pytest tests/ -m gpu``.
ON_GPU = os.environ.get("TDGL_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_GPU:
    # In case jax was imported before this file ran, force the platform
    # through the config API as well, before any backend is initialized.
    jax.config.update("jax_platforms", "cpu")
# Allow float64 solves in tests (explicit dtypes keep float32 paths float32).
jax.config.update("jax_enable_x64", True)

try:
    import matplotlib

    matplotlib.use("Agg")
except ImportError:  # only the plotting tests need it
    pass

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def transport_device():
    """Transport geometry mirroring the reference test fixture
    (``tdgl/test/conftest.py:8``): plus-shaped film, two holes, source/drain
    terminals, two probe points."""
    import tdgl_tpu as tdgl
    from tdgl_tpu.geometry import box, circle

    xi = 1.0
    layer = tdgl.Layer(coherence_length=xi, london_lambda=2, thickness=0.1)
    film = (
        tdgl.Polygon("film", points=box(10))
        .union(box(30, 4, points=400))
        .resample(501)
        .set_name("film")
    )
    hole = tdgl.Polygon("hole1", points=circle(1.5, center=(2, 2)))
    source = tdgl.Polygon(points=box(1e-2, 4, center=(-15, 0))).set_name(
        "source"
    )
    drain = source.copy().scale(xfact=-1).set_name("drain")
    device = tdgl.Device(
        "film",
        layer=layer,
        film=film,
        holes=[hole, hole.copy().scale(xfact=-1, yfact=-1).set_name("hole2")],
        terminals=[source, drain],
        probe_points=[(-10, 0), (10, 0)],
    )
    device.make_mesh(min_points=2000, smooth=100, max_edge_length=xi / 2)
    return device


@pytest.fixture(scope="session")
def transport_device_solution(transport_device, tmp_path_factory):
    import tdgl_tpu as tdgl

    options = tdgl.SolverOptions(
        dt_init=1e-3,
        solve_time=100,
        save_every=100,
        field_units="uT",
        current_units="uA",
        output_file=str(
            tmp_path_factory.mktemp("solutions") / "transport.h5"
        ),
    )
    return tdgl.solve(
        transport_device,
        options,
        applied_vector_potential=tdgl.ConstantField(10, field_units="uT"),
        terminal_currents=dict(source=10, drain=-10),
    )


@pytest.fixture(scope="session")
def box_device():
    import tdgl_tpu as tdgl
    from tdgl_tpu.geometry import box

    xi = 1.5
    layer = tdgl.Layer(coherence_length=xi, london_lambda=1.0, thickness=0.1)
    film = tdgl.Polygon("film", points=box(10)).resample(501)
    device = tdgl.Device("film", layer=layer, film=film)
    device.make_mesh(min_points=2000, smooth=40, max_edge_length=xi / 2)
    return device


@pytest.fixture(scope="session")
def box_device_solution_no_screening(box_device, tmp_path_factory):
    import tdgl_tpu as tdgl

    options = tdgl.SolverOptions(
        dt_init=1e-3,
        solve_time=20,
        save_every=100,
        field_units="uT",
        current_units="uA",
        output_file=str(
            tmp_path_factory.mktemp("solutions") / "box_no_screening.h5"
        ),
    )
    return tdgl.solve(
        box_device,
        options,
        applied_vector_potential=tdgl.ConstantField(50, field_units="uT"),
    )


@pytest.fixture
def gpu_device():
    """The first GPU; tests that need the card take this and skip without
    one (decided here, at run time, so every worker collects the same
    tests)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run with TDGL_TEST_GPU=1 on the"
                    " card")
    return devices[0]
