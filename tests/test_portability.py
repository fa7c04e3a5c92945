"""Small kernels against plain float64 references, and the package's
platform plumbing: host transfers, the compilation-cache directory and the
absence of per-platform branches."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tdgl_tpu
from tdgl_tpu.ops.hexmg import (
    HexMGData,
    block_broadcast,
    block_sum,
    make_hexmg_apply,
)
from tdgl_tpu.ops.screening import induced_vector_potential
from tdgl_tpu.utils import compile_cache
from tdgl_tpu.utils.jaxio import host_scalar, to_numpy, tree_to_numpy

PACKAGE = pathlib.Path(tdgl_tpu.__file__).parent


def _dense_2x2(n):
    """(n/2, n) matrix that sums neighbouring pairs."""
    return np.kron(np.eye(n // 2), np.ones((1, 2)))


def test_block_transfers_are_the_dense_2x2_transfer_and_adjoint():
    R, C = 6, 10
    rng = np.random.default_rng(0)
    r = rng.standard_normal((R, C))
    xc = rng.standard_normal((R // 2, C // 2))
    PR, PC = _dense_2x2(R), _dense_2x2(C)
    restricted = np.asarray(block_sum((R, C), jnp.asarray(r)))
    prolonged = np.asarray(block_broadcast(jnp.asarray(xc)))
    np.testing.assert_allclose(restricted, PR @ r @ PC.T, rtol=1e-13)
    np.testing.assert_allclose(prolonged, PR.T @ xc @ PC, rtol=1e-13)
    # <block_sum r, xc> == <r, block_broadcast xc>
    np.testing.assert_allclose(np.sum(restricted * xc),
                               np.sum(r * prolonged), rtol=1e-13)


def test_pairwise_screening_matches_float64_sum():
    """``A[e] = sum_s J[s] / |r_e - r_s|`` in float32 (with a partial last
    edge block) against the same sum in float64 NumPy."""
    rng = np.random.default_rng(1)
    # Coordinates exact in float32, so the comparison sees the kernel's
    # arithmetic and not the rounding of its inputs.
    sites = rng.uniform(-10, 10, size=(700, 2)).astype(np.float32)
    edges = rng.uniform(-10, 10, size=(300, 2)).astype(np.float32)
    J = rng.standard_normal((700, 2)).astype(np.float32)
    got = np.asarray(induced_vector_potential(
        jnp.asarray(edges, jnp.float32), jnp.asarray(sites, jnp.float32),
        jnp.asarray(J, jnp.float32), block_size=128))
    dist = np.linalg.norm(edges[:, None].astype(np.float64) - sites[None],
                          axis=-1)
    ref = (1.0 / dist) @ J.astype(np.float64)
    assert got.shape == (300, 2)
    # An f32 sum of 700 terms: ~sqrt(700) eps32 of the largest entry; a
    # reduced-precision (TF32-like) product would sit near 1e-3.
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_coarsest_solve_apply_matches_linalg_solve():
    """A hierarchy that is only its coarsest level applies the stored dense
    inverse; in float32 it matches ``np.linalg.solve`` in float64."""
    R, C = 8, 8
    n = R * C
    rng = np.random.default_rng(2)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.linspace(1.0, 10.0, n)) @ Q.T
    mg = HexMGData([dict(Ainv=jnp.asarray(np.linalg.inv(A), jnp.float32))],
                   offsets=((),), shapes=((R, C),))
    b = rng.standard_normal((R, C))
    got = np.asarray(make_hexmg_apply(0.8)(mg, jnp.asarray(b, jnp.float32)))
    ref = np.linalg.solve(A, b.reshape(-1)).reshape(R, C)
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("value, dtype", [
    (np.array([1 + 2j, -3.5j], np.complex64), np.complex64),
    (np.array([True, False, True]), np.bool_),
    (np.float32(2.5), np.float32),
])
def test_to_numpy_round_trips(value, dtype):
    out = to_numpy(jnp.asarray(value))
    assert isinstance(out, np.ndarray) and out.dtype == dtype
    np.testing.assert_array_equal(out, value)


def test_tree_to_numpy_and_host_scalar():
    tree = {"a": jnp.arange(3), "b": (jnp.zeros(()), jnp.ones(2, bool))}
    out = tree_to_numpy(tree)
    assert all(isinstance(leaf, np.ndarray)
               for leaf in jax.tree.leaves(out))
    assert out["b"][0].shape == ()
    assert host_scalar(jnp.asarray(7.0)) == 7.0


def test_compile_cache_dir_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    checkout = PACKAGE.parent
    assert pathlib.Path(compile_cache.cache_dir()) == checkout / ".jax_cache"
    ignored = (checkout / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_keeps_a_configured_directory(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                           str(tmp_path / "other"))
        compile_cache.enable()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        assert not (tmp_path / "other").exists()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_package_has_no_platform_branch():
    """The package runs one code path on every backend: no platform name
    is tested and no Pallas/Mosaic kernel is left."""
    pattern = re.compile(
        r"(?:default_backend\(\)|\.platform)\s*(?:[!=]=|in\b)|pallas",
        re.IGNORECASE)
    hits = [f"{path.relative_to(PACKAGE)}:{i}"
            for path in PACKAGE.rglob("*.py")
            for i, line in enumerate(path.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert hits == []
