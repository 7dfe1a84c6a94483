"""Exact nearest-neighbour distances by brute force.

Static-point search and overlap (reference: DmsaSlam::addStaticPoints /
getOverlap, DmsaSlam.h:264-414) ask, for every query point, whether a valid
reference point lies within a radius.  The clouds hold a few ten thousand
points, so a sweep over all pairs is exact and needs no tree:

    d2[q] = min_r |q - r|^2   over valid r

The distance is the squared difference, not the expansion
|q|^2 - 2 r.q + |r|^2: the expansion cancels catastrophically at scene
coordinates, the difference stays exact to f32 rounding of the result.

Plain JAX over query chunks: XLA fuses the broadcast, the squares and the
min into one reduction, so the [N, Q] distance tile is never written to
device memory (on the H100 the 20480 x 12288 sweep takes less time than
writing that tile would).  A hand-written Triton kernel of the same sweep
(a block of queries in registers, a loop over reference tiles with a
running min) measured slower than this fusion on the H100 at the bench
shapes, and was removed (PERF.md).
"""

import jax
import jax.numpy as jnp

XLA_CHUNK = 32768  # queries per lax.map step: one step at the bench shapes


def _pad_to(a, mult, value):
    pad = (-a.shape[-1]) % mult
    if pad:
        a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)], constant_values=value)
    return a


def _operands(ref_pts, ref_valid, queries):
    """refs [4, N] rows (x, y, z, penalty) and queries [3, Q], f32.

    Invalid references get an +inf penalty and zero coordinates: a NaN/Inf
    in a masked slot must not poison every query's min."""
    r = jnp.where(ref_valid[:, None], ref_pts, 0.0).astype(jnp.float32)
    pen = jnp.where(ref_valid, 0.0, jnp.inf).astype(jnp.float32)
    refs = jnp.concatenate([r.T, pen[None, :]], axis=0)
    q = jnp.nan_to_num(queries.astype(jnp.float32)).T
    return refs, q


def _sweep(refs, q, chunk=XLA_CHUNK):
    """min over refs of |q - r|^2 + penalty, per query.  refs [4, N],
    q [3, Q] -> [Q]."""
    nq = q.shape[1]
    chunk = min(chunk, nq)
    qp = _pad_to(q, chunk, 0.0)

    def one(qc):  # [3, C]
        d2 = refs[3][:, None]
        for k in range(3):
            d = refs[k][:, None] - qc[k][None, :]
            d2 = d2 + d * d
        return jnp.min(d2, axis=0)

    out = jax.lax.map(one, qp.reshape(3, -1, chunk).transpose(1, 0, 2))
    return out.reshape(-1)[:nq]


def min_sq_dist(ref_pts, ref_valid, queries, query_valid):
    """Exact squared distance from each query to the nearest valid reference.

    ref_pts [N, 3] f32, ref_valid [N] bool, queries [Q, 3] f32,
    query_valid [Q] bool.  Returns [Q] f32 (+inf where the query is invalid
    or no valid reference exists).
    """
    refs, q = _operands(ref_pts, ref_valid, queries)
    return jnp.where(query_valid, _sweep(refs, q), jnp.inf)


def has_neighbor_within(ref_pts, ref_valid, queries, query_valid, radius):
    """Boolean [Q]: exists a valid reference within `radius` of the query."""
    d2 = min_sq_dist(ref_pts, ref_valid, queries, query_valid)
    return d2 <= jnp.asarray(radius, jnp.float32) ** 2
