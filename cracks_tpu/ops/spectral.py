"""Closed-form 2x2 symmetric eigendecomposition and the Miehe tensile/
compressive stress split, as differentiable JAX code.

Replaces reference cracks.cc:1691-1737 (``eigen_vectors_and_values``) and
cracks.cc:1923-2120 (``decompose_stress``).  The reference implements the
directional derivative of the split by hand; those hand formulas are the
exact derivative of its primal formulas, so here the linearization is
obtained through ``jax.jvp`` of the primal instead.  The non-smooth
gates are written with ``jnp.where`` so the tangents match the
reference's conventions exactly:

 * positive-part eigenvalues:  lambda+ = where(lambda < 0, 0, lambda)
   with tangent where(lambda < 0, 0, dlambda)   (cracks.cc:2068-2081)
 * positive-part trace:        tr+ = where(tr < 0, 0, tr)
   with tangent where(tr < 0, 0, dtr)           (cracks.cc:2094-2101)

The near-diagonal branch (|E01| < 1e-10 |Eii|, cracks.cc:1700-1710)
selects the trivial eigensystem; unlike the reference's derivative path
(which divides by E01 unconditionally, cracks.cc:1992-2006) the tangent
here follows the selected branch, which is strictly more robust.

Everything is vectorized over arbitrary leading batch dimensions.
The split is only defined for dim == 2, exactly like the reference.
"""

from __future__ import annotations

import jax.numpy as jnp


def eigen_2x2_sym(E):
    """Eigenvalues and eigenvector matrix of symmetric 2x2 tensors.

    E: (..., 2, 2).  Returns (lam1, lam2, P) with P[..., :, 0] the first
    eigenvector, following the reference's branch structure and
    normalization (cracks.cc:1691-1737).
    """
    a = E[..., 0, 0]
    b = E[..., 0, 1]
    c = E[..., 1, 1]

    # The reference uses strict '<' (cracks.cc:1700-1701), which makes
    # E = 0 fall through to the general branch and divide by zero; '<='
    # is identical wherever the reference is finite and keeps E = 0 in
    # the (exact) diagonal branch.
    near_diag = (jnp.abs(b) <= 1e-10 * jnp.abs(a)) | (jnp.abs(b) <= 1e-10 * jnp.abs(c))
    b_safe = jnp.where(near_diag, 1.0, b)

    sq = jnp.sqrt((a - c) * (a - c) + 4.0 * b_safe * b_safe)
    lam1_g = 0.5 * ((a + c) + sq)
    lam2_g = 0.5 * ((a + c) - sq)

    r1 = (lam1_g - a) / b_safe
    r2 = (lam2_g - a) / b_safe
    n1 = 1.0 / jnp.sqrt(1.0 + r1 * r1)
    n2 = 1.0 / jnp.sqrt(1.0 + r2 * r2)

    lam1 = jnp.where(near_diag, a, lam1_g)
    lam2 = jnp.where(near_diag, c, lam2_g)

    v1x = jnp.where(near_diag, 1.0, n1)
    v1y = jnp.where(near_diag, 0.0, n1 * r1)
    v2x = jnp.where(near_diag, 0.0, n2)
    v2y = jnp.where(near_diag, 1.0, n2 * r2)

    P = jnp.stack(
        [jnp.stack([v1x, v2x], axis=-1), jnp.stack([v1y, v2y], axis=-1)],
        axis=-2,
    )
    return lam1, lam2, P


def stress_split_components(exx, exy, eyy, lam_coeff, mu_coeff):
    """Component form of the Miehe split (array-friendly: operates on
    arbitrary-shaped scalar component arrays, no small trailing matrix
    dims).  Returns ((sp_xx, sp_xy, sp_yy), (sm_xx, sm_xy, sm_yy)).

    See stress_split_2d for the math and differentiation notes."""
    a, b, c = exx, exy, eyy
    trE = a + c
    sq = jnp.sqrt((a - c) * (a - c) + 4.0 * b * b)   # l1 - l2 >= 0
    l1 = 0.5 * (trE + sq)
    l2 = 0.5 * (trE - sq)
    l1p = jnp.where(l1 < 0.0, 0.0, l1)
    l2p = jnp.where(l2 < 0.0, 0.0, l2)

    scale = jnp.abs(a) + jnp.abs(c) + 2.0 * jnp.abs(b)
    degenerate = sq <= 1e-12 * scale
    inv_sq = 1.0 / jnp.where(degenerate, 1.0, sq)

    # spectral projections P1 = (E - l2 I)/sq, P2 = (l1 I - E)/sq
    ep_xx_g = (l1p * (a - l2) + l2p * (l1 - a)) * inv_sq
    ep_yy_g = (l1p * (c - l2) + l2p * (l1 - c)) * inv_sq
    ep_xy_g = (l1p - l2p) * b * inv_sq
    # isotropic limit: E+ = E if tr >= 0 else 0
    pos = trE >= 0.0
    ep_xx = jnp.where(degenerate, jnp.where(pos, a, 0.0), ep_xx_g)
    ep_yy = jnp.where(degenerate, jnp.where(pos, c, 0.0), ep_yy_g)
    ep_xy = jnp.where(degenerate, jnp.where(pos, b, 0.0), ep_xy_g)

    trp = jnp.where(trE < 0.0, 0.0, trE)
    lam = lam_coeff
    mu = mu_coeff
    sp_xx = lam * trp + 2.0 * mu * ep_xx
    sp_yy = lam * trp + 2.0 * mu * ep_yy
    sp_xy = 2.0 * mu * ep_xy
    sm_xx = lam * (trE - trp) + 2.0 * mu * (a - ep_xx)
    sm_yy = lam * (trE - trp) + 2.0 * mu * (c - ep_yy)
    sm_xy = 2.0 * mu * (b - ep_xy)
    return (sp_xx, sp_xy, sp_yy), (sm_xx, sm_xy, sm_yy)


def stress_split_2d(E, lam_coeff, mu_coeff):
    """Miehe spectral split of the linear-elastic stress into tensile and
    compressive parts (cracks.cc:1959-1970):

        sigma+ = lambda tr+(E) I + 2 mu E+
        sigma- = lambda (tr E - tr+(E)) I + 2 mu (E - E+)

    E: (..., 2, 2) symmetric strains; lam_coeff/mu_coeff broadcastable
    scalars or (...,) arrays.  Returns (sigma_plus, sigma_minus).

    E+ is built from *spectral projections* P_i = ±(E - lambda_j I)/(l1-l2)
    instead of explicit eigenvectors.  The primal values are identical to
    the eigenvector form, but autodiff through this formulation yields the
    exact derivative everywhere the eigenvalues are distinct — including
    near-diagonal strains, where an eigenvector-branch formulation would
    freeze the eigenbasis and lose the shear sensitivity d(sigma+)/dE01
    (the reference's hand-coded general-branch derivative
    (cracks.cc:1982-2091) is exact there too, so jax.jvp of this function
    reproduces it).  At (near-)isotropic points lambda1 == lambda2 the
    projections are singular; E+ degenerates smoothly to E (both
    eigenvalues positive) or 0 (both negative), with the matching tangent.
    """
    a = E[..., 0, 0]
    b = E[..., 0, 1]
    c = E[..., 1, 1]
    trE = a + c
    sq = jnp.sqrt((a - c) * (a - c) + 4.0 * b * b)   # l1 - l2 >= 0
    l1 = 0.5 * (trE + sq)
    l2 = 0.5 * (trE - sq)
    l1p = jnp.where(l1 < 0.0, 0.0, l1)
    l2p = jnp.where(l2 < 0.0, 0.0, l2)

    scale = jnp.abs(a) + jnp.abs(c) + 2.0 * jnp.abs(b)
    degenerate = sq <= 1e-12 * scale
    sq_safe = jnp.where(degenerate, 1.0, sq)

    eye = jnp.eye(2, dtype=E.dtype)
    # spectral projections: P1 = (E - l2 I)/(l1 - l2), P2 = (l1 I - E)/(l1 - l2)
    P1 = (E - l2[..., None, None] * eye) / sq_safe[..., None, None]
    P2 = (l1[..., None, None] * eye - E) / sq_safe[..., None, None]
    Ep_gen = l1p[..., None, None] * P1 + l2p[..., None, None] * P2
    # isotropic limit: l1 == l2 == tr/2 -> E+ = E if positive else 0
    Ep_iso = jnp.where((trE < 0.0)[..., None, None], jnp.zeros_like(E), E)
    Ep = jnp.where(degenerate[..., None, None], Ep_iso, Ep_gen)

    trp = jnp.where(trE < 0.0, 0.0, trE)
    lam_b = jnp.asarray(lam_coeff)[..., None, None]
    mu_b = jnp.asarray(mu_coeff)[..., None, None]
    sp = lam_b * trp[..., None, None] * eye + 2.0 * mu_b * Ep
    sm = (lam_b * (trE - trp)[..., None, None] * eye
          + 2.0 * mu_b * (E - Ep))
    return sp, sm


def full_stress(E, lam_coeff, mu_coeff):
    """Plain linear-elastic stress lambda tr(E) I + 2 mu E, any dim."""
    dim = E.shape[-1]
    trE = jnp.trace(E, axis1=-2, axis2=-1)
    eye = jnp.eye(dim, dtype=E.dtype)
    lam_b = jnp.asarray(lam_coeff)[..., None, None]
    mu_b = jnp.asarray(mu_coeff)[..., None, None]
    return lam_b * trE[..., None, None] * eye + 2.0 * mu_b * E
