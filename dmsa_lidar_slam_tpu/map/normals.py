"""k-nearest-neighbor normal estimation on the hash grid.

Equivalent of the reference's NormalEstimationOMP with kSearch(6) and a
viewpoint at the sensor origin (updateNormals, DmsaSlam.h:557-568): per
point, covariance of its k nearest neighbors (itself included — PCL
semantics when the query belongs to the input cloud), normal = eigenvector
of the smallest eigenvalue, flipped toward the viewpoint.
"""

import jax.numpy as jnp

from dmsa_lidar_slam_tpu.ops import knn

K_NEIGHBORS = 6  # DmsaSlam.h:565


def estimate_normals(points, mask, grid_size, viewpoint=None, k: int = K_NEIGHBORS, cap: int = 8):
    """Normals [N, 3] f32 for a voxel-downsampled cloud.

    `grid_size` sets the neighborhood scale (the cloud's own downsampling
    grid is the natural choice — neighbors live within a cell or two).
    Points with fewer than 3 valid neighbors get normal (0, 0, 1).
    Neighbors come from the exact k-NN hash grid (ops.knn), the
    reference's kSearch(6) semantics (DmsaSlam.h:557-568).
    """
    if viewpoint is None:
        viewpoint = jnp.zeros(3, dtype=points.dtype)

    from dmsa_lidar_slam_tpu.ops.eig3 import smallest_eigvec_sym3

    grid = knn.build_grid(points, mask, 2.0 * grid_size)
    idx, d2, valid = knn.knn_indices(grid, points, mask, k, cap=cap)

    neigh = grid.sorted_pts[idx]  # [N, k, 3]
    w = valid.astype(points.dtype)  # [N, k]
    cnt = jnp.maximum(jnp.sum(w, axis=1), 1.0)
    mean = jnp.sum(neigh * w[:, :, None], axis=1) / cnt[:, None]
    d = (neigh - mean[:, None, :]) * w[:, :, None]
    cov = jnp.einsum("nki,nkj->nij", d, d) / jnp.maximum(cnt - 1.0, 1.0)[:, None, None]
    n_neigh = jnp.sum(w, axis=1)

    # smallest-eigenvalue eigenvector, closed form (ops.eig3): this runs
    # inside the fused per-scan jit on every keyframe scan, where a batched
    # iterative eigh would be a loop of small solves
    normal = smallest_eigvec_sym3(cov)

    # orient toward viewpoint (PCL flipNormalTowardsViewpoint)
    to_vp = viewpoint[None, :] - points
    flip = jnp.sum(normal * to_vp, axis=1) < 0.0
    normal = jnp.where(flip[:, None], -normal, normal)

    degenerate = n_neigh < 3.0
    default = jnp.zeros_like(normal).at[:, 2].set(1.0)
    normal = jnp.where(degenerate[:, None], default, normal)
    return jnp.where(mask[:, None], normal, default).astype(jnp.float32)
