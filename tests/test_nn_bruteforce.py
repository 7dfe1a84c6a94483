"""Brute-force NN distances (ops.nn_bruteforce) vs scipy cKDTree."""

import numpy as np
import pytest
from scipy.spatial import cKDTree

import jax.numpy as jnp

from dmsa_lidar_slam_tpu.ops import nn_bruteforce as bf


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_min_sq_dist_matches_kdtree(rng):
    ref = rng.normal(size=(700, 3)).astype(np.float32) * 5
    q = rng.normal(size=(450, 3)).astype(np.float32) * 5
    got = np.asarray(
        bf.min_sq_dist(jnp.asarray(ref), jnp.ones(700, bool), jnp.asarray(q), jnp.ones(450, bool))
    )
    d, _ = cKDTree(ref).query(q, k=1)
    np.testing.assert_allclose(got, d**2, rtol=2e-4, atol=1e-5)


def test_respects_ref_validity(rng):
    ref = np.zeros((10, 3), np.float32)
    ref[0] = [1.0, 0.0, 0.0]  # the only valid ref
    valid = np.zeros(10, bool)
    valid[0] = True
    q = np.zeros((4, 3), np.float32)
    got = np.asarray(bf.min_sq_dist(jnp.asarray(ref), jnp.asarray(valid), jnp.asarray(q), jnp.ones(4, bool)))
    np.testing.assert_allclose(got, 1.0, rtol=1e-5)


def test_invalid_queries_and_empty_ref(rng):
    ref = rng.normal(size=(16, 3)).astype(np.float32)
    q = rng.normal(size=(8, 3)).astype(np.float32)
    qv = np.zeros(8, bool)
    qv[:3] = True
    got = np.asarray(bf.min_sq_dist(jnp.asarray(ref), jnp.ones(16, bool), jnp.asarray(q), jnp.asarray(qv)))
    assert np.all(np.isinf(got[3:]))
    assert np.all(np.isfinite(got[:3]))
    # no valid reference at all -> all inf
    got2 = np.asarray(bf.min_sq_dist(jnp.asarray(ref), jnp.zeros(16, bool), jnp.asarray(q), jnp.asarray(qv)))
    assert np.all(np.isinf(got2))


def test_has_neighbor_within_matches_kdtree(rng):
    ref = rng.uniform(-4, 4, size=(900, 3)).astype(np.float32)
    q = rng.uniform(-4, 4, size=(600, 3)).astype(np.float32)
    radius = 0.35
    got = np.asarray(
        bf.has_neighbor_within(
            jnp.asarray(ref), jnp.ones(900, bool), jnp.asarray(q), jnp.ones(600, bool), radius
        )
    )
    d, _ = cKDTree(ref).query(q, k=1)
    want = d <= radius
    # allow disagreement only in a tiny band around the radius (f32 rounding)
    band = np.abs(d - radius) < 1e-4
    assert np.array_equal(got[~band], want[~band])


def test_large_offset_coordinates(rng):
    """Centering keeps f32 cancellation in check for far-from-origin clouds."""
    offset = np.array([300.0, -450.0, 120.0], np.float32)
    ref = rng.normal(size=(500, 3)).astype(np.float32) * 3 + offset
    q = rng.normal(size=(300, 3)).astype(np.float32) * 3 + offset
    got = np.asarray(
        bf.min_sq_dist(jnp.asarray(ref), jnp.ones(500, bool), jnp.asarray(q), jnp.ones(300, bool))
    )
    d, _ = cKDTree(ref).query(q, k=1)
    np.testing.assert_allclose(got, d**2, rtol=1e-3, atol=1e-4)


def _case(name, rng):
    """(refs [N,3], ref_valid [N], queries [Q,3]) for the kernel cases."""
    if name.startswith("sizes"):
        n, nq = (int(v) for v in name.split("_")[1:])
        return (
            rng.normal(size=(n, 3)).astype(np.float32) * 5,
            np.ones(n, bool),
            rng.normal(size=(nq, 3)).astype(np.float32) * 5,
        )
    ref = rng.normal(size=(300, 3)).astype(np.float32) * 3
    q = rng.normal(size=(200, 3)).astype(np.float32) * 3
    valid = rng.uniform(size=300) > 0.4
    if name == "invalid_refs":
        return ref, valid, q
    if name == "all_invalid":
        return ref, np.zeros(300, bool), q
    if name == "nan_in_masked":
        ref[~valid] = np.nan
        ref[np.flatnonzero(~valid)[:5]] = np.inf
        return ref, valid, q
    if name == "large_offset":
        off = np.array([300.0, -450.0, 120.0], np.float32)
        return ref + off, valid, q + off
    raise ValueError(name)


@pytest.mark.parametrize(
    "name",
    [
        "sizes_1_1",
        "sizes_700_450",
        "sizes_1025_130",
        "invalid_refs",
        "all_invalid",
        "nan_in_masked",
        "large_offset",
    ],
)
def test_sweep_matches_kdtree(name, rng):
    """The chunked sweep against an f64 cKDTree with the chip-check bound
    (|d2 - d2_f64| <= 1e-4 + 1e-3 d2): sizes off the chunk multiple, masked
    and poisoned references, scene-scale coordinates."""
    ref, valid, q = _case(name, rng)
    refs, qq = bf._operands(jnp.asarray(ref), jnp.asarray(valid), jnp.asarray(q))
    got = np.asarray(bf._sweep(refs, qq, chunk=64))
    assert got.shape == (len(q),)
    np.testing.assert_array_equal(got, np.asarray(bf._sweep(refs, qq)))
    if not valid.any():
        assert np.all(np.isinf(got))
        return
    d, _ = cKDTree(ref[valid].astype(np.float64)).query(q.astype(np.float64))
    assert np.all(np.abs(got - d**2) <= 1e-4 + 1e-3 * d**2)


def test_no_production_path_interprets():
    """No Pallas kernel is left in the package, so nothing can run in the
    Pallas interpreter on a production path; the platform helper reports
    the CPU here and keeps host buffers un-reused."""
    import pathlib

    import dmsa_lidar_slam_tpu
    from dmsa_lidar_slam_tpu.utils import platform

    pkg = pathlib.Path(dmsa_lidar_slam_tpu.__file__).parent
    for src in pkg.rglob("*.py"):
        text = src.read_text()
        assert "pallas_call" not in text and "interpret=" not in text, src
    assert platform.platform() == "cpu"
    assert not platform.reuse_host_buffers()


@pytest.mark.gpu
def test_sweep_on_gpu_matches_kdtree(gpu, rng):
    """The sweep compiled for the card (chip_smoke.py phase 4 runs the same
    check at the bench widths)."""
    ref, valid, q = _case("large_offset", rng)
    got = np.asarray(bf.min_sq_dist(jnp.asarray(ref), jnp.asarray(valid), jnp.asarray(q), jnp.ones(len(q), bool)))
    d, _ = cKDTree(ref[valid].astype(np.float64)).query(q.astype(np.float64))
    assert np.all(np.abs(got - d**2) <= 1e-4 + 1e-3 * d**2)
