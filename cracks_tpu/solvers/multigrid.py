"""Matrix-free geometric multigrid preconditioner.

Replaces the reference's Trilinos ML algebraic multigrid
(cracks.cc:2477-2497) with a *geometric* V-cycle over the forest's
global-coarsening hierarchy — the mesh levels are free in a tree-based
mesh (SURVEY.md section 7 step 3; cf. Jodlbauer/Langer/Wick,
"Matrix-free multigrid solvers for phase-field fracture problems",
arXiv:1902.08112):

 * level meshes: the forest truncated to level <= l (2:1 balance is
   preserved under truncation); level states/active sets by vertex
   injection from the fine mesh (coarse vertices persist under
   refinement);
 * level operators: rediscretized Jacobian actions (jax.jvp of the
   level residual), reduced by the level's own hanging/Dirichlet/active
   constraints;
 * smoother: Chebyshev(deg) on the Jacobi-preconditioned operator with
   a power-iteration eigenvalue estimate (the analogue of Trilinos ML's
   Chebyshev smoother);
 * transfer: Q1 interpolation stencils between consecutive levels,
   restriction is the exact transpose.

The V-cycle preconditions each diagonal block (displacement and phase
field) of the block-triangular Newton system inside the matrix-free CG
solve; the whole solve is one jitted computation.

Measured behavior (Sneddon, CG rtol 1e-8): on undegraded elasticity the
V-cycle converges mesh-independently (20 CG its vs 233 Jacobi at 3.7k
dofs).  On the *degraded* phase-field operator the crack is a 1-2 cell
wide strip whose coefficient is ~1e-9 of the bulk; that strip is
sub-cell on every coarse grid, so no geometric coarse space represents
its interior modes and the coarse correction stops helping (the
reference's *algebraic* ML aggregation builds coefficient-aware coarse
dofs instead, cracks.cc:2480-2486).  Until a strip-aware coarse space
(aggregation over degraded dofs) is added, the default preconditioner
for fracture steps remains Jacobi; GMG is available via
Preconditioner = gmg and wins on the pre-cracking load steps.
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import physics
from ..ops.constraints import (Constraints, condense_residual, expand_update,
                               make_constraints)


class Level(NamedTuple):
    """One multigrid level (finest last).  Transfer arrays live on the
    finer level and reference the next-coarser level's vertices."""

    ca: physics.CellArrays
    con: Constraints
    inject_p: jax.Array    # (n_v_l,) int32 — this level's vertex -> finest vertex
    inject_u: jax.Array    # (n_v_l*dim,) int32 — flat u-dof injection
    # prolongation from the next-coarser level (None on the coarsest):
    masters_p: jax.Array | None   # (n_v_l, 2^dim) int32 coarse vertex ids
    weights_p: jax.Array | None   # (n_v_l, 2^dim)
    masters_u: jax.Array | None   # (n_v_l*dim, 2^dim) int32 flat u dofs
    weights_u: jax.Array | None


class Hierarchy(NamedTuple):
    levels: tuple          # coarsest ... finest-1 (the finest is the System)
    # the finest level's transfer from levels[-1]:
    masters_p: jax.Array
    weights_p: jax.Array
    masters_u: jax.Array
    weights_u: jax.Array


def _expand_u(masters, weights, dim):
    comp = np.arange(dim)
    m_u = (masters.astype(np.int64)[:, None, :] * dim
           + comp[None, :, None]).reshape(-1, masters.shape[1])
    w_u = np.repeat(weights, dim, axis=0)
    return m_u, w_u


def build_hierarchy(forest, fine_mesh, params, lam_fn, dirichlet_fn,
                    dtype=jnp.float64, min_coarse_vertices: int = 500):
    """Build the GMG hierarchy for the current forest state.

    lam_fn(mesh) -> (lam_cells, mu_cells); dirichlet_fn(mesh) ->
    (mask_u (n_v, dim), mask_p (n_v,)).  Levels with fewer than
    min_coarse_vertices vertices are merged into the coarsest level.
    """
    from ..mesh import interpolation_stencil

    dim = fine_mesh.dim
    lmax = int(forest.level.max())
    # choose level set: 0..lmax-1 (finest handled by the System itself),
    # skipping leading levels that are already tiny
    level_ids = []
    for l in range(lmax):
        f_l = forest.truncated(l)
        if f_l.n_cells == forest.n_cells:
            break  # truncation is a no-op from here on
        level_ids.append((l, f_l))
    # drop too-small duplicates from the top (keep at least the coarsest)
    levels = []
    prev = None  # (forest, mesh)
    fine_keys = fine_mesh.vertex_keys
    for l, f_l in level_ids:
        m_l = f_l.extract()
        if prev is not None and m_l.n_vertices == prev[1].n_vertices:
            continue
        lam, mu = lam_fn(m_l)
        ca = physics.build_cell_arrays(m_l, lam, mu, dtype=dtype)
        mask_u, mask_p = dirichlet_fn(m_l)
        con = make_constraints(m_l, mask_u, mask_p, dtype=dtype)
        pos = np.searchsorted(fine_keys, m_l.vertex_keys)
        assert (fine_keys[np.minimum(pos, len(fine_keys) - 1)]
                == m_l.vertex_keys).all(), "coarse vertex missing in fine mesh"
        inject_p = pos.astype(np.int64)
        inject_u = (inject_p[:, None] * dim
                    + np.arange(dim)[None, :]).reshape(-1)
        if prev is None:
            masters = weights = m_u = w_u = None
        else:
            masters, weights = interpolation_stencil(prev[0], prev[1], m_l)
            m_u, w_u = _expand_u(masters, weights, dim)
        levels.append(Level(
            ca=ca, con=con,
            inject_p=jnp.asarray(inject_p, dtype=jnp.int32),
            inject_u=jnp.asarray(inject_u, dtype=jnp.int32),
            masters_p=None if masters is None else jnp.asarray(masters, jnp.int32),
            weights_p=None if weights is None else jnp.asarray(weights, dtype),
            masters_u=None if m_u is None else jnp.asarray(m_u, jnp.int32),
            weights_u=None if w_u is None else jnp.asarray(w_u, dtype)))
        prev = (f_l, m_l)

    if not levels:
        return None
    masters, weights = interpolation_stencil(prev[0], prev[1], fine_mesh)
    m_u, w_u = _expand_u(masters, weights, dim)
    return Hierarchy(
        levels=tuple(levels),
        masters_p=jnp.asarray(masters, jnp.int32),
        weights_p=jnp.asarray(weights, dtype),
        masters_u=jnp.asarray(m_u, jnp.int32),
        weights_u=jnp.asarray(w_u, dtype))


# ---------------------------------------------------------------------------
# jitted machinery
# ---------------------------------------------------------------------------

def _prolong(x_c, masters, weights):
    return jnp.einsum("fm,fm->f", weights, x_c[masters])


def _restrict(r_f, masters, weights, n_coarse):
    out = jnp.zeros(n_coarse, dtype=r_f.dtype)
    return out.at[masters].add(weights * r_f[:, None])


def _chebyshev(op, Dinv, b, lam_max, degree, rng: float = 20.0):
    """Chebyshev smoother for D^{-1}A with eigenvalues in
    [lam_max/rng, lam_max*1.2]; zero initial guess (deal.II
    PreconditionChebyshev conventions: 1.2 safety factor on the
    eigenvalue estimate).  An underestimated upper bound makes
    Chebyshev AMPLIFY the top modes and destroys the V-cycle, so the
    safety margin is essential.

    The smoothing range rng defaults to 20, which is calibrated to the
    loose Gershgorin lambda_max (the bound overestimates by 1.5-2.3x,
    so /20 lands near a true /10); callers that carry the sharp
    Lanczos estimate (galerkin/lattice smoothers) pass rng = 4 — with
    a Galerkin-exact coarse correction the smoother only has to damp
    what the 2:1-coarse space cannot represent (measured: range 4 +
    Lanczos cuts CG its/solve ~2x vs range 20 + Gershgorin,
    scripts/iters_experiment.py)."""
    upper = 1.2 * lam_max
    lower = lam_max / rng
    theta = 0.5 * (upper + lower)
    delta = 0.5 * (upper - lower)
    x = jax.tree_util.tree_map(jnp.zeros_like, b)
    r = b  # b - A x0 with x0 = 0
    # first step
    alpha = 1.0 / theta
    p = jax.tree_util.tree_map(lambda rr: alpha * (Dinv * rr), r)
    x = p
    sigma = theta / delta
    rho_old = 1.0 / sigma
    for _ in range(degree - 1):
        r = jax.tree_util.tree_map(lambda bb, aa: bb - aa, b, op(x))
        rho = 1.0 / (2.0 * sigma - rho_old)
        f1 = rho * rho_old
        f2 = 2.0 * rho / delta
        p = jax.tree_util.tree_map(
            lambda pp, rr: f1 * pp + f2 * (Dinv * rr), p, r)
        x = jax.tree_util.tree_map(lambda xx, pp: xx + pp, x, p)
        rho_old = rho
    return x


# ---------------------------------------------------------------------------
# Chebyshev spectral-window policy (shared by galerkin.py / lattice.py)
#
# Two regimes, keyed on problem size:
#  * sharp (production, > SHARP_SPECTRUM_MIN_DOFS): m-step Lanczos
#    lambda_max + narrow smoothing range 4 — cuts CG its/solve ~2x
#    (scripts/iters_experiment.py ladder, scripts/iters_r4.json).
#  * pinned (golden-size problems): the original Gershgorin bound +
#    range 20.  NOT a correctness split — both regimes satisfy the
#    same solve tolerances — but the PDAS has marginal-dof basin
#    freedom (nearby active sets that both satisfy discrete
#    complementarity, see newton.py's band discussion), and changing
#    the preconditioner at golden sizes was measured to steer
#    miehe_shear_1 onto a neighbouring basin 1.5e-6 away in Load.
#    The golden tables pin the reference's basin digit-for-digit, so
#    golden-size solves keep the smoother that tracks it; production
#    sizes, where no digit-level oracle exists and wall-clock rules,
#    get the sharp window.  CRACKS_TPU_LAMBDA=lanczos|gershgorin and
#    CRACKS_TPU_CHEB_RANGE override both regimes (read at trace time).
# ---------------------------------------------------------------------------

SHARP_SPECTRUM_MIN_DOFS = int(os.environ.get(
    "CRACKS_TPU_SHARP_MIN_DOFS", "50000"))


def sharp_spectrum(n_dofs: int) -> bool:
    env = os.environ.get("CRACKS_TPU_LAMBDA")
    if env:
        return env == "lanczos"
    return n_dofs > SHARP_SPECTRUM_MIN_DOFS


def smoothing_range(sharp: bool) -> float:
    env = os.environ.get("CRACKS_TPU_CHEB_RANGE")
    if env:
        return float(env)
    return 4.0 if sharp else 20.0


def lanczos_lambda_max(op, Dinv, free, m: int = 16):
    """Sharp lambda_max(D^{-1}A) estimate on the free subspace: m-step
    Lanczos on the symmetrized S = D^(-1/2) A D^(-1/2), top Ritz value.

    Unlike plain power iteration — which was observed to sit 30% below
    lambda_max when the dominant mode is localized in the degraded
    crack strip (galerkin._gershgorin_lambda_max docstring) and
    thereby diverge the V-cycle — Lanczos convergence is governed by
    the spectral gaps, not the start vector's overlap with the
    dominant mode, so localized and clustered extremes are both
    reached in ~10-16 steps (validated against dense eigvalsh on every
    lattice level, lattice.lanczos_lambda).  `op` must already mask
    input and output to the free subspace; the hash-sign start vector
    has generic overlap with every mode in any basis.  f32 loss of
    orthogonality only duplicates converged Ritz values, harmless for
    a max readout."""
    dtype = Dinv.dtype
    sq = jnp.sqrt(jnp.abs(Dinv))

    def S(x):
        return sq * op(sq * x)

    idx = jnp.arange(free.shape[0], dtype=jnp.uint32)
    h = (idx * jnp.uint32(2654435761)) >> jnp.uint32(16)
    sign = jnp.where((h & 1) == 1, -1.0, 1.0).astype(dtype)
    v = jnp.where(free, sign, 0.0)
    n0 = jnp.sqrt(jnp.vdot(v, v).real)
    v = jnp.where(n0 > 0, v / jnp.maximum(n0, 1e-30), v)

    def body(i, carry):
        v_prev, v, beta, alphas, betas = carry
        w = S(v) - beta * v_prev
        alpha = jnp.vdot(v, w).real
        w = w - alpha * v
        beta_new = jnp.sqrt(jnp.vdot(w, w).real)
        v_new = jnp.where(beta_new > 0,
                          w / jnp.maximum(beta_new, 1e-30), w)
        return (v, v_new, beta_new, alphas.at[i].set(alpha),
                betas.at[i].set(beta_new))

    zeros = jnp.zeros((m,), dtype)
    carry = (jnp.zeros_like(v), v, jnp.asarray(0.0, dtype), zeros, zeros)
    _, _, _, alphas, betas = jax.lax.fori_loop(0, m, body, carry,
                                               unroll=True)
    T = (jnp.diag(alphas) + jnp.diag(betas[:-1], 1)
         + jnp.diag(betas[:-1], -1))
    return jnp.max(jnp.linalg.eigvalsh(T.astype(jnp.float32))).astype(
        dtype)


def _power_lambda_max(op, Dinv, seed, iters=15):
    """Estimate lambda_max(D^{-1}A) by power iteration."""
    v = Dinv * seed
    v = v / (jnp.linalg.norm(v) + 1e-300)

    def body(_, v):
        w = Dinv * op(v)
        return w / (jnp.linalg.norm(w) + 1e-300)

    v = jax.lax.fori_loop(0, iters, body, v)
    w = Dinv * op(v)
    lam = jnp.vdot(v, w) / (jnp.vdot(v, v) + 1e-300)
    return jnp.maximum(lam.real, 1e-30)


class GMGBlock(NamedTuple):
    """Per-block (u or phi) V-cycle data assembled per solve."""

    ops: tuple          # level operators, coarsest..finest
    Dinvs: tuple        # Jacobi inverses per level
    lam_maxes: tuple    # eigenvalue estimates per level
    masters: tuple      # prolongation stencils per level (None at 0)
    weights: tuple
    n_dofs: tuple
    zmasks: tuple       # per-level constrained-dof masks (True = zero)


def make_vcycle(block: GMGBlock, degree: int = 3, coarse_degree: int = 12):
    """Build the V-cycle preconditioner application M^{-1} r."""
    L = len(block.ops)

    def cycle(level, b):
        # every level works strictly on its free subspace: restricted
        # residuals and prolonged corrections must be re-masked or the
        # Dirichlet/active/hanging entries pollute the CG Krylov space
        b = jnp.where(block.zmasks[level], 0.0, b)
        op = block.ops[level]
        Dinv = block.Dinvs[level]
        lam = block.lam_maxes[level]
        if level == 0:
            return _chebyshev(op, Dinv, b, lam, coarse_degree)
        x = _chebyshev(op, Dinv, b, lam, degree)
        r = b - op(x)
        r_c = _restrict(r, block.masters[level], block.weights[level],
                        block.n_dofs[level - 1])
        e_c = cycle(level - 1, r_c)
        x = x + jnp.where(
            block.zmasks[level], 0.0,
            _prolong(e_c, block.masters[level], block.weights[level]))
        # post-smoothing
        r = b - op(x)
        x = x + _chebyshev(op, Dinv, r, lam, degree)
        return x

    return lambda b: cycle(L - 1, b)
