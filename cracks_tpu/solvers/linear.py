"""Linear solvers for the Newton systems.

Two paths, mirroring the reference's solve() (cracks.cc:2744-2777):

 * direct — assemble the element Jacobians, reduce with the (dense)
   constraint matrix and LU-factorize, ALL ON DEVICE (one jit).  This
   replaces Trilinos Amesos SolverDirect (cracks.cc:2750-2758) and is
   exact, so it also serves as the correctness oracle for the
   matrix-free path.  Dense is the on-device "sparse direct"
   analogue (XLA has no sparse LU); it is capped at
   DENSE_DIRECT_MAX_DOFS — larger systems fall back to the tight-
   tolerance Krylov path, which is the sanctioned stand-in (SURVEY
   section 2b: "dense/banded solve on device, or CG with tight tol").

 * cg — matrix-free block-triangular solve.  The quasi-monolithic
   Jacobian is block *lower* triangular (displacement rows do not couple
   to phase-field columns because pf_extra is extrapolated,
   cracks.cc:2353-2366), so instead of GMRES on the monolithic system
   (cracks.cc:2762-2771) we solve A_uu du = b_u and then
   A_pp dpf = b_p - B du with two preconditioned CG iterations — both
   blocks are symmetric positive (semi)definite on the free dofs.  Dot
   products reduce across devices when sharded (parallel/).

Solution layout is flat (u: (n_v*dim,), phi: (n_v,)); the global dof
numbering of the monolithic system is [u dofs | phi dofs + n_v*dim].
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import physics
from ..ops.constraints import (Constraints, condense_residual, expand_update)


# ---------------------------------------------------------------------------
# direct path
# ---------------------------------------------------------------------------

# Dense direct solves above this size would need multi-GB (n, n)
# intermediates; larger systems take the tight-tolerance Krylov path
# instead (newton._solve catches the RuntimeError).
DENSE_DIRECT_MAX_DOFS = 8000


@partial(jax.jit, static_argnames=("dim", "with_split", "monolithic"))
def _direct_dense_solve(u, phi, phi_old, phi_oold, ca, sc, con, active,
                        rhs_u, rhs_p, *, dim, with_split, monolithic):
    """One-dispatch dense reduced solve: element Jacobians -> dense
    global matrix (scatter-add) -> dense constraint matrix C (identity
    on free dofs, Q1 interpolation rows for hanging children, zeroed
    constrained columns — AffineConstraints::close() semantics) ->
    LU of C^T A C + I_constrained -> x = C x_red.

    Returns (du, dp, min |U_ii|, max |U_ii|) — the caller uses the
    diagonal extrema to detect an exactly singular factor (the analogue
    of Amesos' factorization failure)."""
    n_ud = u.shape[0]
    n_v = phi.shape[0]
    n = n_ud + n_v
    jac = physics.element_matrices(
        u, phi, phi_old, phi_oold, ca, sc,
        dim=dim, with_split=with_split, monolithic=monolithic)
    gids = jnp.concatenate([ca.gather_u.T, ca.gather_p.T + n_ud],
                           axis=1)                     # (n_c, ndl)
    A = jnp.zeros((n, n), u.dtype).at[
        gids[:, :, None], gids[:, None, :]].add(jac)

    constrained = jnp.concatenate(
        [con.dirichlet_u, con.dirichlet_p | active])
    if con.hang_child_u.shape[0]:
        constrained = constrained.at[con.hang_child_u].set(True)
        constrained = constrained.at[con.hang_child_p + n_ud].set(True)
    free = (~constrained).astype(u.dtype)
    C = jnp.diag(free)
    if con.hang_child_u.shape[0]:
        C = C.at[con.hang_child_u[:, None],
                 con.hang_masters_u].add(con.hang_weights_u)
        C = C.at[con.hang_child_p[:, None] + n_ud,
                 con.hang_masters_p + n_ud].add(con.hang_weights)
    # drop constrained columns (chains resolve to zero in the
    # homogeneous update space; see _constraint_matrix notes)
    C = C * free[None, :]
    A_red = C.T @ (A @ C) + jnp.diag(constrained.astype(u.dtype))
    lu, piv = jax.scipy.linalg.lu_factor(A_red)
    b = jnp.concatenate([rhs_u, rhs_p])
    x = C @ jax.scipy.linalg.lu_solve((lu, piv), b)
    udiag = jnp.abs(jnp.diagonal(lu))
    return x[:n_ud], x[n_ud:], jnp.min(udiag), jnp.max(udiag)


def solve_direct(u, phi, phi_old, phi_oold, ca: physics.CellArrays,
                 sc: physics.Scalars, con: Constraints, active,
                 rhs_u, rhs_p, *, dim: int, with_split: bool,
                 monolithic: bool):
    """Exact on-device dense solve of the reduced Newton system.

    Returns (du (n_v*dim,), dp (n_v,), 1) with constraints distributed.
    Raises RuntimeError for systems too large for the dense path or for
    an exactly singular factor (the caller falls back to CG, whose
    iterates stay in the range space — same role as the reference's
    GMRES, cracks.cc:2762-2771)."""
    n_dofs = u.shape[0] + phi.shape[0]
    if n_dofs > DENSE_DIRECT_MAX_DOFS:
        raise RuntimeError(
            f"dense direct solve capped at {DENSE_DIRECT_MAX_DOFS} DoFs "
            f"(got {n_dofs}); use the Krylov path")
    du, dp, umin, umax = _direct_dense_solve(
        u, phi, phi_old, phi_oold, ca, sc, con, active, rhs_u, rhs_p,
        dim=dim, with_split=with_split, monolithic=monolithic)
    umin, umax = float(umin), float(umax)
    if not np.isfinite(umax) or umin == 0.0 or not np.isfinite(umin):
        raise RuntimeError("singular factor in dense direct solve")
    return du, dp, 1


# ---------------------------------------------------------------------------
# matrix-free CG path
# ---------------------------------------------------------------------------

def _pcg(op: Callable, b, Minv, rtol, atol, maxiter):
    """Preconditioned conjugate gradients on a pytree vector space."""
    dot = lambda a, c: sum(jnp.vdot(x, y) for x, y in
                           zip(jax.tree_util.tree_leaves(a),
                               jax.tree_util.tree_leaves(c)))
    x0 = jax.tree_util.tree_map(jnp.zeros_like, b)
    r0 = b
    z0 = jax.tree_util.tree_map(lambda m, r: m * r, Minv, r0)
    bnorm = jnp.sqrt(dot(b, b).real)
    tol2 = jnp.maximum(rtol * bnorm, atol) ** 2

    def cond(state):
        x, r, z, p, rz, k = state
        return (dot(r, r).real > tol2) & (k < maxiter)

    def body(state):
        x, r, z, p, rz, k = state
        Ap = op(p)
        denom = dot(p, Ap)
        alpha = jnp.where(denom != 0, rz / denom, 0.0)
        x = jax.tree_util.tree_map(lambda xx, pp: xx + alpha * pp, x, p)
        r = jax.tree_util.tree_map(lambda rr, aa: rr - alpha * aa, r, Ap)
        z = jax.tree_util.tree_map(lambda m, rr: m * rr, Minv, r)
        rz_new = dot(r, z)
        beta = jnp.where(rz != 0, rz_new / rz, 0.0)
        p = jax.tree_util.tree_map(lambda zz, pp: zz + beta * pp, z, p)
        return x, r, z, p, rz_new, k + 1

    state = (x0, r0, z0, z0, dot(r0, z0), jnp.asarray(0))
    x, r, z, p, rz, k = jax.lax.while_loop(cond, body, state)
    return x, k


@partial(jax.jit, static_argnames=("dim", "with_split", "monolithic",
                                   "which", "chunk"))
def _cg_block_chunk(u, phi, phi_old, phi_oold, ca, sc, con, active,
                    Minv, state, tol2, *, dim, with_split, monolithic,
                    which: str, chunk: int):
    """Advance the PCG iteration on one block by at most `chunk` steps,
    carrying the exact Krylov state across calls, so the host can check
    convergence between chunks without any mathematical restart."""
    zero_p = jnp.zeros_like(phi)
    zero_u = jnp.zeros_like(u)

    def jv(du, dp):
        eu, ep = expand_update(du, dp, con, active)
        ju, jp = physics.jacobian_vector_product(
            u, phi, eu, ep, phi_old, phi_oold, ca, sc,
            dim=dim, with_split=with_split, monolithic=monolithic)
        return condense_residual(ju, jp, con, active)

    op = ((lambda x: jv(x, zero_p)[0]) if which == "u"
          else (lambda x: jv(zero_u, x)[1]))

    def cond(s):
        x, r, z, pvec, rz, k, k0 = s
        return (jnp.vdot(r, r).real > tol2) & (k - k0 < chunk)

    def body(s):
        x, r, z, pvec, rz, k, k0 = s
        Ap = op(pvec)
        denom = jnp.vdot(pvec, Ap)
        alpha = jnp.where(denom != 0, rz / denom, 0.0)
        x = x + alpha * pvec
        r = r - alpha * Ap
        z = Minv * r
        rz_new = jnp.vdot(r, z)
        beta = jnp.where(rz != 0, rz_new / rz, 0.0)
        pvec = z + beta * pvec
        return x, r, z, pvec, rz_new, k + 1, k0

    x, r, z, pvec, rz, k = state
    s = jax.lax.while_loop(cond, body, (x, r, z, pvec, rz, k, k))
    return s[:6], jnp.vdot(s[1], s[1]).real


def solve_cg_block_chunked(u, phi, phi_old, phi_oold, ca, sc, con, active,
                           rhs_u, rhs_p, diag_u, diag_p, rtol, atol,
                           *, dim, with_split, monolithic, maxiter,
                           chunk: int = 100):
    """Host-chunked variant of solve_cg_block: identical math (exact
    Krylov state carry), each device call bounded by `chunk` CG steps."""
    free_u = ~(con.dirichlet_u | con.hang_mask_u)
    free_p = ~(con.dirichlet_p | con.hang_mask_p | active)
    Minv_u = jnp.where(free_u & (jnp.abs(diag_u) > 0), 1.0 / diag_u, 1.0)
    Minv_p = jnp.where(free_p & (jnp.abs(diag_p) > 0), 1.0 / diag_p, 1.0)
    kw = dict(dim=dim, with_split=with_split, monolithic=monolithic)

    def run_block(which, b, Minv):
        bnorm2 = float(jnp.vdot(b, b).real)
        tol2 = max(rtol * np.sqrt(bnorm2), atol) ** 2
        z0 = Minv * b
        state = (jnp.zeros_like(b), b, z0, z0, jnp.vdot(b, z0),
                 jnp.asarray(0))
        rr = bnorm2
        while rr > tol2 and int(state[5]) < maxiter:
            state, rr_dev = _cg_block_chunk(
                u, phi, phi_old, phi_oold, ca, sc, con, active, Minv,
                state, tol2, which=which, chunk=chunk, **kw)
            rr = float(rr_dev)
        return state[0], int(state[5])

    du, it_u = run_block("u", rhs_u, Minv_u)

    # coupling: b_p' = rhs_p - B du
    def jv_full(duu, dpp):
        eu, ep = expand_update(duu, dpp, con, active)
        ju, jp = physics.jacobian_vector_product(
            u, phi, eu, ep, phi_old, phi_oold, ca, sc, **kw)
        return condense_residual(ju, jp, con, active)

    _, b_coupled = jv_full(du, jnp.zeros_like(phi))
    dp, it_p = run_block("p", rhs_p - b_coupled, Minv_p)

    du, dp = expand_update(du, dp, con, active)
    return du, dp, it_u + it_p


def _level_block_ops(u, phi, phi_old, phi_oold, ca, con, active, sc,
                     *, dim, with_split, monolithic):
    """(op_u, op_p, Dinv_u, Dinv_p) for one mesh level: condensed
    Jacobian block actions + Jacobi inverses on the free dofs."""
    zero_p = jnp.zeros_like(phi)
    zero_u = jnp.zeros_like(u)

    def jv(du, dp):
        eu, ep = expand_update(du, dp, con, active)
        ju, jp = physics.jacobian_vector_product(
            u, phi, eu, ep, phi_old, phi_oold, ca, sc,
            dim=dim, with_split=with_split, monolithic=monolithic)
        return condense_residual(ju, jp, con, active)

    op_u = lambda x: jv(x, zero_p)[0]
    op_p = lambda x: jv(zero_u, x)[1]
    diag_u, diag_p = physics.jacobi_diagonal_approx(
        u, phi, phi_old, phi_oold, ca, sc, dim=dim, monolithic=monolithic)
    free_u = ~(con.dirichlet_u | con.hang_mask_u)
    free_p = ~(con.dirichlet_p | con.hang_mask_p | active)
    Dinv_u = jnp.where(free_u & (jnp.abs(diag_u) > 0), 1.0 / diag_u, 1.0)
    Dinv_p = jnp.where(free_p & (jnp.abs(diag_p) > 0), 1.0 / diag_p, 1.0)
    zero_mask_u = ~free_u
    zero_mask_p = ~free_p
    return jv, op_u, op_p, Dinv_u, Dinv_p, zero_mask_u, zero_mask_p


@partial(jax.jit, static_argnames=("dim", "with_split", "monolithic",
                                   "maxiter", "degree"))
def solve_cg_gmg(u, phi, phi_old, phi_oold, ca: physics.CellArrays,
                 sc: physics.Scalars, con: Constraints, active,
                 rhs_u, rhs_p, hierarchy, rtol, atol,
                 *, dim: int, with_split: bool, monolithic: bool,
                 maxiter: int, degree: int = 3):
    """Block-triangular solve with geometric-multigrid-preconditioned CG
    (the Trilinos AMG replacement; see solvers/multigrid.py)."""
    from .multigrid import (GMGBlock, _power_lambda_max, make_vcycle)

    jv, op_u_f, op_p_f, Dinv_u_f, Dinv_p_f, zmu_f, zmp_f = _level_block_ops(
        u, phi, phi_old, phi_oold, ca, con, active, sc,
        dim=dim, with_split=with_split, monolithic=monolithic)

    # level states: restrict phi/u down the hierarchy by full weighting
    # (injection misrepresents the crack's degraded coefficient on coarse
    # levels and stalls the coarse-grid correction); active sets by
    # injection (a boolean property of the fine dofs)
    from .multigrid import _restrict
    n_lvls = len(hierarchy.levels)
    state_chain = []
    fu, fp, fpo, fpoo = u, phi, phi_old, phi_oold
    masters_chain = [*(l.masters_p for l in hierarchy.levels[1:]),
                     hierarchy.masters_p]
    weights_chain = [*(l.weights_p for l in hierarchy.levels[1:]),
                     hierarchy.weights_p]
    masters_chain_u = [*(l.masters_u for l in hierarchy.levels[1:]),
                       hierarchy.masters_u]
    weights_chain_u = [*(l.weights_u for l in hierarchy.levels[1:]),
                       hierarchy.weights_u]
    for i in range(n_lvls - 1, -1, -1):
        lvl = hierarchy.levels[i]
        n_c = lvl.inject_p.shape[0]
        n_cu = lvl.inject_u.shape[0]
        mp, wp = masters_chain[i], weights_chain[i]
        mu_, wu_ = masters_chain_u[i], weights_chain_u[i]
        norm_p = _restrict(jnp.ones(mp.shape[0], dtype=fp.dtype), mp, wp, n_c)
        norm_u = _restrict(jnp.ones(mu_.shape[0], dtype=fu.dtype), mu_, wu_, n_cu)
        fu = _restrict(fu, mu_, wu_, n_cu) / norm_u
        fp = _restrict(fp, mp, wp, n_c) / norm_p
        fpo = _restrict(fpo, mp, wp, n_c) / norm_p
        fpoo = _restrict(fpoo, mp, wp, n_c) / norm_p
        state_chain.insert(0, (fu, fp, fpo, fpoo))

    ops_u, ops_p, dinv_u, dinv_p = [], [], [], []
    lam_u, lam_p = [], []
    zm_u_list, zm_p_list = [], []
    masters_u, weights_u, masters_p, weights_p = [None], [None], [None], [None]
    n_ud_list, n_p_list = [], []
    for i, lvl in enumerate(hierarchy.levels):
        ul, pl, pol, pool = state_chain[i]
        actl = active[lvl.inject_p]
        _, opu, opp, diu, dip, zmu, zmp = _level_block_ops(
            ul, pl, pol, pool, lvl.ca, lvl.con, actl, sc,
            dim=dim, with_split=with_split, monolithic=monolithic)

        def wrap(op, zm):
            return lambda x: jnp.where(zm, 0.0, op(jnp.where(zm, 0.0, x)))

        ops_u.append(wrap(opu, zmu))
        ops_p.append(wrap(opp, zmp))
        dinv_u.append(diu)
        dinv_p.append(dip)
        zm_u_list.append(zmu)
        zm_p_list.append(zmp)
        lam_u.append(_power_lambda_max(ops_u[-1], diu, jnp.ones_like(ul)))
        lam_p.append(_power_lambda_max(ops_p[-1], dip, jnp.ones_like(pl)))
        n_ud_list.append(lvl.inject_u.shape[0])
        n_p_list.append(lvl.inject_p.shape[0])
        if i > 0:
            masters_u.append(lvl.masters_u)
            weights_u.append(lvl.weights_u)
            masters_p.append(lvl.masters_p)
            weights_p.append(lvl.weights_p)

    # finest level
    ops_u.append(lambda x: jnp.where(zmu_f, 0.0, op_u_f(jnp.where(zmu_f, 0.0, x))))
    ops_p.append(lambda x: jnp.where(zmp_f, 0.0, op_p_f(jnp.where(zmp_f, 0.0, x))))
    dinv_u.append(Dinv_u_f)
    dinv_p.append(Dinv_p_f)
    lam_u.append(_power_lambda_max(ops_u[-1], Dinv_u_f, jnp.ones_like(u)))
    lam_p.append(_power_lambda_max(ops_p[-1], Dinv_p_f, jnp.ones_like(phi)))
    masters_u.append(hierarchy.masters_u)
    weights_u.append(hierarchy.weights_u)
    masters_p.append(hierarchy.masters_p)
    weights_p.append(hierarchy.weights_p)
    n_ud_list.append(u.shape[0])
    n_p_list.append(phi.shape[0])
    zm_u_list.append(zmu_f)
    zm_p_list.append(zmp_f)

    block_u = GMGBlock(ops=tuple(ops_u), Dinvs=tuple(dinv_u),
                       lam_maxes=tuple(lam_u), masters=tuple(masters_u),
                       weights=tuple(weights_u), n_dofs=tuple(n_ud_list),
                       zmasks=tuple(zm_u_list))
    block_p = GMGBlock(ops=tuple(ops_p), Dinvs=tuple(dinv_p),
                       lam_maxes=tuple(lam_p), masters=tuple(masters_p),
                       weights=tuple(weights_p), n_dofs=tuple(n_p_list),
                       zmasks=tuple(zm_p_list))
    M_u = make_vcycle(block_u, degree=degree)
    M_p = make_vcycle(block_p, degree=degree)

    du, it_u = _pcg_M(ops_u[-1], rhs_u, M_u, rtol, atol, maxiter)
    _, b_coupled = jv(du, jnp.zeros_like(phi))
    rhs_p2 = rhs_p - b_coupled
    dp, it_p = _pcg_M(ops_p[-1], rhs_p2, M_p, rtol, atol, maxiter)

    du, dp = expand_update(du, dp, con, active)
    return du, dp, it_u + it_p


def _pcg_M(op, b, M, rtol, atol, maxiter):
    """PCG with a general (linear, SPD) preconditioner application M."""
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = M(r0)
    bnorm = jnp.sqrt(jnp.vdot(b, b).real)
    tol2 = jnp.maximum(rtol * bnorm, atol) ** 2

    def cond(state):
        x, r, z, p, rz, k = state
        return (jnp.vdot(r, r).real > tol2) & (k < maxiter)

    def body(state):
        x, r, z, p, rz, k = state
        Ap = op(p)
        denom = jnp.vdot(p, Ap)
        alpha = jnp.where(denom != 0, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = jnp.vdot(r, z)
        beta = jnp.where(rz != 0, rz_new / rz, 0.0)
        p = z + beta * p
        return x, r, z, p, rz_new, k + 1

    state = (x0, r0, z0, z0, jnp.vdot(r0, z0), jnp.asarray(0))
    x, r, z, p, rz, k = jax.lax.while_loop(cond, body, state)
    return x, k


@partial(jax.jit, static_argnames=("dim", "with_split", "monolithic",
                                   "maxiter"))
def solve_cg_block(u, phi, phi_old, phi_oold, ca: physics.CellArrays,
                   sc: physics.Scalars, con: Constraints, active,
                   rhs_u, rhs_p, diag_u, diag_p, rtol, atol,
                   *, dim: int, with_split: bool, monolithic: bool,
                   maxiter: int):
    """Block-triangular matrix-free solve (see module docstring).

    diag_u/diag_p: Jacobi preconditioner diagonals (raw Jacobian diag;
    entries at constrained dofs are ignored).
    Returns (du, dp, iters) with constraints distributed."""
    zero_p = jnp.zeros_like(phi)
    zero_u = jnp.zeros_like(u)

    def jv(du, dp):
        eu, ep = expand_update(du, dp, con, active)
        ju, jp = physics.jacobian_vector_product(
            u, phi, eu, ep, phi_old, phi_oold, ca, sc,
            dim=dim, with_split=with_split, monolithic=monolithic)
        return condense_residual(ju, jp, con, active)

    free_u = ~(con.dirichlet_u | con.hang_mask_u)
    free_p = ~(con.dirichlet_p | con.hang_mask_p | active)
    Minv_u = jnp.where(free_u & (jnp.abs(diag_u) > 0), 1.0 / diag_u, 1.0)
    Minv_p = jnp.where(free_p & (jnp.abs(diag_p) > 0), 1.0 / diag_p, 1.0)

    # u block
    op_u = lambda du: jv(du, zero_p)[0]
    du, it_u = _pcg(op_u, rhs_u, Minv_u, rtol, atol, maxiter)

    # coupling: b_p' = rhs_p - B du
    _, b_coupled = jv(du, zero_p)
    rhs_p2 = rhs_p - b_coupled

    op_p = lambda dp: jv(zero_u, dp)[1]
    dp, it_p = _pcg(op_p, rhs_p2, Minv_p, rtol, atol, maxiter)

    du, dp = expand_update(du, dp, con, active)
    return du, dp, it_u + it_p
