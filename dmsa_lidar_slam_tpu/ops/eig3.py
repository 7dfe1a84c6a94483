"""Closed-form symmetric 3x3 spectral functions — no iterative eigensolver.

The DMSA information matrix is V diag(1/max(lambda, floor)) V^T of the cell
covariance (Gaussians.h:181-201).  jnp.linalg.eigh lowers to an iterative
solver (a loop of small solves for large batches of 3x3); instead:

  - eigenvalues by the trigonometric closed form (Smith's method),
  - the matrix function WITHOUT eigenvectors via spectral polynomial
    calculus: for symmetric A with eigenvalues l1 >= l2 >= l3 and any g,
        g(A) = dd1 * I + dd12 * (A - l1 I) + dd123 * (A - l1 I)(A - l2 I)
    with Newton divided differences dd of g — exact for distinct
    eigenvalues and continuous in the degenerate limit (divided
    differences fall back to derivatives).

Everything is branch-free element-wise VPU math that vmaps trivially.
"""

import jax.numpy as jnp

_EPS = 1e-12


def sym_eigvals3(A):
    """Eigenvalues of symmetric [..., 3, 3], descending [..., 3]."""
    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    eye = jnp.eye(3, dtype=A.dtype)
    B = A - q[..., None, None] * eye
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, _EPS))
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    r = detB / (2.0 * p * p * p)
    r = jnp.clip(r, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    l1 = q + 2.0 * p * jnp.cos(phi)
    l3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    # p ~ 0 (isotropic): all eigenvalues = q
    iso = p2 < _EPS
    l1 = jnp.where(iso, q, l1)
    l2 = jnp.where(iso, q, l2)
    l3 = jnp.where(iso, q, l3)
    return jnp.stack([l1, l2, l3], axis=-1)


def _divided_diff(g, dg, a, b):
    """(g(a) - g(b)) / (a - b), falling back to dg at the midpoint when the
    nodes (nearly) coincide."""
    diff = a - b
    small = jnp.abs(diff) < 1e-6
    safe = jnp.where(small, 1.0, diff)
    return jnp.where(small, dg(0.5 * (a + b)), (g(a) - g(b)) / safe)


def matrix_function_sym3(A, g, dg, d2g):
    """g(A) for symmetric [..., 3, 3] via the Newton-form spectral polynomial.

    dg / d2g supply first/second derivatives for the confluent (repeated
    eigenvalue) limits.
    """
    lam = sym_eigvals3(A)
    l1, l2, l3 = lam[..., 0], lam[..., 1], lam[..., 2]
    dd1 = g(l1)
    dd12 = _divided_diff(g, dg, l1, l2)
    dd23 = _divided_diff(g, dg, l2, l3)
    # second divided difference; confluent fallback to d2g/2
    diff13 = l1 - l3
    small13 = jnp.abs(diff13) < 1e-6
    safe13 = jnp.where(small13, 1.0, diff13)
    dd123 = jnp.where(
        small13, 0.5 * d2g((l1 + l3) * 0.5), (dd12 - dd23) / safe13
    )
    eye = jnp.eye(3, dtype=A.dtype)
    A1 = A - l1[..., None, None] * eye
    A2 = A - l2[..., None, None] * eye
    out = (
        dd1[..., None, None] * eye
        + dd12[..., None, None] * A1
        + dd123[..., None, None] * (A1 @ A2)
    )
    # exact symmetrization (the polynomial is symmetric analytically)
    return 0.5 * (out + jnp.swapaxes(out, -1, -2))


def pack_sym6(A):
    """Symmetric [..., 3, 3] -> packed [..., 6] (00, 01, 02, 11, 12, 22)."""
    return jnp.stack(
        [A[..., 0, 0], A[..., 0, 1], A[..., 0, 2], A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]],
        axis=-1,
    )


def unpack_sym6(a):
    """Packed [..., 6] -> symmetric [..., 3, 3]."""
    a00, a01, a02, a11, a12, a22 = (a[..., i] for i in range(6))
    return jnp.stack(
        [
            jnp.stack([a00, a01, a02], axis=-1),
            jnp.stack([a01, a11, a12], axis=-1),
            jnp.stack([a02, a12, a22], axis=-1),
        ],
        axis=-2,
    )


def sym6_matvec(a, v):
    """Packed symmetric [..., 6] times vector [..., 3] -> [..., 3]."""
    a00, a01, a02, a11, a12, a22 = (a[..., i] for i in range(6))
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [a00 * x + a01 * y + a02 * z, a01 * x + a11 * y + a12 * z, a02 * x + a12 * y + a22 * z],
        axis=-1,
    )


def sym6_inner(a, b):
    """<A, B> Frobenius inner product of packed symmetrics (off-diag doubled)."""
    w = jnp.asarray([1.0, 2.0, 2.0, 1.0, 2.0, 1.0], dtype=a.dtype)
    return jnp.sum(a * b * w, axis=-1)


def sym_eigvals6(a):
    """Eigenvalues of packed symmetric [..., 6], descending [..., 3].

    Same trigonometric closed form as sym_eigvals3 but in packed columns —
    pure elementwise VPU math, no [..., 3, 3] layouts on the hot path.
    """
    a00, a01, a02, a11, a12, a22 = (a[..., i] for i in range(6))
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, _EPS))
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = jnp.clip(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    l1 = q + 2.0 * p * jnp.cos(phi)
    l3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    iso = p2 < _EPS
    l1 = jnp.where(iso, q, l1)
    l2 = jnp.where(iso, q, l2)
    l3 = jnp.where(iso, q, l3)
    return jnp.stack([l1, l2, l3], axis=-1)


def _sym6_mul(a, b):
    """Product of two packed symmetrics KNOWN to commute (same eigenbasis,
    e.g. A + c1 I and A + c2 I) -> packed symmetric [..., 6]."""
    p00, p01, p02, p11, p12, p22 = (a[..., i] for i in range(6))
    q00, q01, q02, q11, q12, q22 = (b[..., i] for i in range(6))
    return jnp.stack(
        [
            p00 * q00 + p01 * q01 + p02 * q02,
            p00 * q01 + p01 * q11 + p02 * q12,
            p00 * q02 + p01 * q12 + p02 * q22,
            p01 * q01 + p11 * q11 + p12 * q12,
            p01 * q02 + p11 * q12 + p12 * q22,
            p02 * q02 + p12 * q12 + p22 * q22,
        ],
        axis=-1,
    )


def _add_diag6(a, c):
    """a + c * I in packed form."""
    d = jnp.stack([c, jnp.zeros_like(c), jnp.zeros_like(c), c, jnp.zeros_like(c), c], axis=-1)
    return a + d


def matrix_function_sym6(a, g, dg, d2g):
    """g(A) for packed symmetric [..., 6] — the packed twin of
    matrix_function_sym3 (bit-identical math, no 3x3 layouts)."""
    lam = sym_eigvals6(a)
    l1, l2, l3 = lam[..., 0], lam[..., 1], lam[..., 2]
    dd1 = g(l1)
    dd12 = _divided_diff(g, dg, l1, l2)
    dd23 = _divided_diff(g, dg, l2, l3)
    diff13 = l1 - l3
    small13 = jnp.abs(diff13) < 1e-6
    safe13 = jnp.where(small13, 1.0, diff13)
    dd123 = jnp.where(small13, 0.5 * d2g((l1 + l3) * 0.5), (dd12 - dd23) / safe13)
    a1 = _add_diag6(a, -l1)
    a2 = _add_diag6(a, -l2)
    prod = _sym6_mul(a1, a2)
    out = _add_diag6(dd12[..., None] * a1 + dd123[..., None] * prod, dd1)
    return out


def floored_inverse_sym6(a, floor):
    """Packed twin of floored_inverse_sym3: [..., 6] -> [..., 6]."""
    fns = _floor_fns(floor)
    return matrix_function_sym6(a, *fns)


def _floor_fns(floor):
    # HARD eigenvalue floor g(x) = 1/max(x, floor) — the reference's exact
    # semantics (Gaussians.h:181-201).  r4 used a smooth C^oo barrier
    # h(x) = x + floor*exp(-x/floor) to keep the spectral polynomial's
    # confluent fallbacks continuous, but (a) nothing differentiates
    # through the frozen per-iteration Lambda anywhere in the optimizer,
    # (b) g itself IS continuous under the hard floor (only dg/d2g jump at
    # the kink, and those only enter the <1e-6-separated-eigenvalue
    # fallbacks, where their contribution is O(|l_i - l_j|)), and (c) the
    # ~5 exp() per point were a measurable cost of the cell-build kernel
    # at 196k-point submaps.
    m = floor

    def g(x):
        return 1.0 / jnp.maximum(x, m)

    def dg(x):
        return jnp.where(x > m, -1.0 / jnp.maximum(x * x, _EPS), 0.0)

    def d2g(x):
        return jnp.where(x > m, 2.0 / jnp.maximum(x * x * x, _EPS), 0.0)

    return g, dg, d2g


def floored_inverse_sym3(A, floor):
    """Eigenvalue-floored inverse V diag(1/max(lambda, floor)) V^T without
    computing V (the information matrix, Gaussians.h:181-201) — the hard
    floor, matching the reference exactly (see _floor_fns for why the r4
    smooth barrier was retired).  max() also absorbs numerical-noise
    negative eigenvalues from masked junk cells (no NaN can leak out)."""
    return matrix_function_sym3(A, *_floor_fns(floor))


def smallest_eigvec_sym3(A):
    """Unit eigenvector of the SMALLEST eigenvalue of symmetric [..., 3, 3].

    Closed form, branch-free (no iterative eigh, the reason this module
    exists): the null space of B = A - lam_min I is
    spanned by any nonzero cross product of two rows of B; the candidate
    with the largest norm is numerically best.  Near-degenerate spectra
    (lam2 ~ lam_min) make the direction ill-defined mathematically; the
    argmax still returns a valid unit vector in the eigenspace.  Fully
    degenerate (isotropic) inputs fall back to +z.
    """
    lam_min = sym_eigvals3(A)[..., 2]
    eye = jnp.eye(3, dtype=A.dtype)
    B = A - lam_min[..., None, None] * eye
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c12 = jnp.cross(r1, r2)
    c20 = jnp.cross(r2, r0)
    cands = jnp.stack([c01, c12, c20], axis=-2)  # [..., 3, 3]
    norms = jnp.sum(cands * cands, axis=-1)  # [..., 3]
    best = jnp.argmax(norms, axis=-1)
    v = jnp.take_along_axis(cands, best[..., None, None].repeat(3, axis=-1), axis=-2)[
        ..., 0, :
    ]
    nrm = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    fallback = jnp.zeros_like(v).at[..., 2].set(1.0)
    ok = nrm[..., 0] > 1e-20
    return jnp.where(ok[..., None], v / jnp.where(ok[..., None], nrm, 1.0), fallback)
