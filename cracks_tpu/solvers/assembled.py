"""Stored-element-matrix Krylov operator (the 'assembled' path).

The reference assembles a Trilinos block sparse matrix once per Newton
iteration and every GMRES iteration is a sparse matvec
(cracks.cc:2129-2498 assembly, 2762-2771 solve).  Round 1 instead
recomputed the full physics Jacobian-vector product (including the
spectral-split linearization) on every Krylov iteration — exact, but
each iteration cost a full element-kernel sweep.

This module is the JAX analogue of "assemble once, matvec many":
the per-cell dense Newton Jacobians (ndl x ndl, ndl = 2^dim*(dim+1))
are computed ONCE per Newton iteration (vmapped jacfwd of the element
residual, cell-axis-last, see ops/physics.py) and every Krylov
iteration is then

    gather (ndl, n_c) -> batched dense (ndl x ndl) matvec -> scatter-add

which is purely HBM-bandwidth bound (~ndl^2 * n_c reads) — orders of
magnitude cheaper than re-deriving the physics.  The element matrices
are exactly jacfwd of the residual, so this operator is bit-equivalent
in exact arithmetic to the jax.jvp operator it replaces.

Block structure: the quasi-monolithic Jacobian is block lower triangular
(u rows do not couple to phi columns, cracks.cc:2353-2366), so the
blocks A_uu = J[:nud_l,:nud_l], A_pu = J[nud_l:,:nud_l] and
A_pp = J[nud_l:,nud_l:] are sliced from the same stored array.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import physics
from ..ops.constraints import (Constraints, hanging_interpolate_p,
                               hanging_interpolate_u, hanging_transpose_p,
                               hanging_transpose_u)


def build_jacobians(u, phi, phi_old, phi_oold, ca: physics.CellArrays,
                    sc: physics.Scalars, *, dim: int, with_split: bool,
                    monolithic: bool):
    """(ndl, ndl, n_c) cell-last element Jacobians for the current
    Newton linearization point."""
    return physics.element_matrices(
        u, phi, phi_old, phi_oold, ca, sc, dim=dim,
        with_split=with_split, monolithic=monolithic, cell_last=True)


# ---------------------------------------------------------------------------
# raw block matvecs (no constraints)
# ---------------------------------------------------------------------------

def matvec_uu(jac_cl, ca: physics.CellArrays, x, *, dim: int):
    nvc = ca.gather_p.shape[0]
    nud_l = nvc * dim
    xe = x[ca.gather_u]                                     # (nud_l, c)
    ye = jnp.einsum("ijc,jc->ic", jac_cl[:nud_l, :nud_l], xe,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.zeros_like(x).at[ca.gather_u].add(ye)


def matvec_pp(jac_cl, ca: physics.CellArrays, x, *, dim: int):
    nvc = ca.gather_p.shape[0]
    nud_l = nvc * dim
    xe = x[ca.gather_p]                                     # (nvc, c)
    ye = jnp.einsum("ijc,jc->ic", jac_cl[nud_l:, nud_l:], xe,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.zeros_like(x).at[ca.gather_p].add(ye)


def matvec_pu(jac_cl, ca: physics.CellArrays, xu, n_p: int, *, dim: int):
    """Coupling block action: phi rows, u columns (B du)."""
    nvc = ca.gather_p.shape[0]
    nud_l = nvc * dim
    xe = xu[ca.gather_u]
    ye = jnp.einsum("ijc,jc->ic", jac_cl[nud_l:, :nud_l], xe,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.zeros(n_p, dtype=xu.dtype).at[ca.gather_p].add(ye)


@partial(jax.jit, static_argnames=("dim", "n_ud", "n_p"))
def diagonals(jac_cl, ca: physics.CellArrays, n_ud: int, n_p: int,
              *, dim: int):
    """Exact global Jacobi diagonals (du (n_ud,), dp (n_p,)) from the
    stored element matrices."""
    nvc = ca.gather_p.shape[0]
    nud_l = nvc * dim
    ndl = jac_cl.shape[0]
    idx = jnp.arange(ndl)
    d_loc = jac_cl[idx, idx, :]                             # (ndl, c)
    du = jnp.zeros(n_ud, dtype=jac_cl.dtype).at[ca.gather_u].add(
        d_loc[:nud_l])
    dp = jnp.zeros(n_p, dtype=jac_cl.dtype).at[ca.gather_p].add(
        d_loc[nud_l:])
    return du, dp


# ---------------------------------------------------------------------------
# condensed block operators (hanging + Dirichlet + active set)
# ---------------------------------------------------------------------------

def make_condensed_ops(jac_cl, ca: physics.CellArrays, con: Constraints,
                       active, n_p: int, *, dim: int):
    """(op_u, op_p, op_pu): condensed block actions on the free subspace.

    Each op is expand -> raw matvec -> condense, matching the
    C^T A C reduction of the direct path (linear.py)."""
    free_u = ~(con.dirichlet_u | con.hang_mask_u)
    free_p = ~(con.dirichlet_p | con.hang_mask_p | active)

    def op_u(x):
        x = jnp.where(free_u, x, 0.0)
        x = hanging_interpolate_u(x, con)
        y = matvec_uu(jac_cl, ca, x, dim=dim)
        y = hanging_transpose_u(y, con)
        return jnp.where(free_u, y, 0.0)

    def op_p(x):
        x = jnp.where(free_p, x, 0.0)
        x = hanging_interpolate_p(x, con)
        y = matvec_pp(jac_cl, ca, x, dim=dim)
        y = hanging_transpose_p(y, con)
        return jnp.where(free_p, y, 0.0)

    def op_pu(xu):
        xu = jnp.where(free_u, xu, 0.0)
        xu = hanging_interpolate_u(xu, con)
        y = matvec_pu(jac_cl, ca, xu, n_p, dim=dim)
        y = hanging_transpose_p(y, con)
        return jnp.where(free_p, y, 0.0)

    return op_u, op_p, op_pu


# ---------------------------------------------------------------------------
# chunked PCG on one block (stored-matrix operator)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("dim", "which", "chunk"))
def _cg_chunk(jac_cl, ca, con, active, Minv, state, tol2,
              *, dim: int, which: str, chunk: int):
    """Advance PCG by at most `chunk` iterations in one device call,
    carrying the exact Krylov state (same contract as
    linear._cg_block_chunk, with the stored-matrix operator)."""
    n_p = con.dirichlet_p.shape[0]
    op_u, op_p, _ = make_condensed_ops(jac_cl, ca, con, active, n_p, dim=dim)
    op = op_u if which == "u" else op_p

    def cond(s):
        x, r, z, pvec, rz, k, k0, xb, rrb = s
        return (jnp.vdot(r, r).real > tol2) & (k - k0 < chunk)

    def body(s):
        x, r, z, pvec, rz, k, k0, xb, rrb = s
        Ap = op(pvec)
        denom = jnp.vdot(pvec, Ap)
        alpha = jnp.where(denom != 0, rz / denom, 0.0)
        x = x + alpha * pvec
        r = r - alpha * Ap
        rr = jnp.vdot(r, r).real
        better = rr < rrb
        xb = jnp.where(better, x, xb)
        rrb = jnp.where(better, rr, rrb)
        z = Minv * r
        rz_new = jnp.vdot(r, z)
        beta = jnp.where(rz != 0, rz_new / rz, 0.0)
        pvec = z + beta * pvec
        return x, r, z, pvec, rz_new, k + 1, k0, xb, rrb

    x, r, z, pvec, rz, k, xb, rrb = state
    s = jax.lax.while_loop(cond, body, (x, r, z, pvec, rz, k, k, xb, rrb))
    return s[:6] + (s[7], s[8]), s[8]


@partial(jax.jit, static_argnames=("dim",))
def residual_update(jac_cl, ca, con, active, du, dp, rhs_u, rhs_p,
                    *, dim: int):
    """(rhs - J x) on the free subspace for a free-subspace update
    (du, dp) — the iterative-refinement correction right-hand side."""
    n_p = con.dirichlet_p.shape[0]
    op_u, op_p, op_pu = make_condensed_ops(jac_cl, ca, con, active, n_p,
                                           dim=dim)
    return rhs_u - op_u(du), rhs_p - op_pu(du) - op_p(dp)


@partial(jax.jit, static_argnames=("dim",))
def _coupling_rhs(jac_cl, ca, con, active, du, rhs_p, *, dim: int):
    n_p = con.dirichlet_p.shape[0]
    _, _, op_pu = make_condensed_ops(jac_cl, ca, con, active, n_p, dim=dim)
    return rhs_p - op_pu(du)


def solve_cg_block(jac_cl, ca, con, active, rhs_u, rhs_p, diag_u, diag_p,
                   rtol, atol, *, dim: int, maxiter: int, chunk: int = 200):
    """Block-triangular stored-matrix CG: A_uu du = b_u, then
    A_pp dp = b_p - A_pu du, each by host-chunked Jacobi-PCG.

    Returns (du, dp, iters) on the FREE subspace (caller expands)."""
    free_u = ~(con.dirichlet_u | con.hang_mask_u)
    free_p = ~(con.dirichlet_p | con.hang_mask_p | active)
    Minv_u = jnp.where(free_u & (jnp.abs(diag_u) > 0), 1.0 / diag_u, 1.0)
    Minv_p = jnp.where(free_p & (jnp.abs(diag_p) > 0), 1.0 / diag_p, 1.0)

    def run_block(which, b, Minv):
        bnorm2 = float(jnp.vdot(b, b).real)
        # floor at ~100 eps relative: below that CG stagnates on
        # rounding noise and the iterate can drift to huge magnitudes
        # while chasing an unreachable tolerance
        eps = float(jnp.finfo(jac_cl.dtype).eps)
        tol2 = max(rtol * np.sqrt(bnorm2), atol,
                   100.0 * eps * np.sqrt(bnorm2)) ** 2
        z0 = Minv * b
        state = (jnp.zeros_like(b), b, z0, z0, jnp.vdot(b, z0),
                 jnp.asarray(0), jnp.zeros_like(b),
                 jnp.asarray(bnorm2, b.dtype))
        rr = bnorm2
        stalls = 0
        while rr > tol2 and int(state[5]) < maxiter:
            prev_rr = rr
            state, rr_dev = _cg_chunk(jac_cl, ca, con, active, Minv,
                                      state, tol2, dim=dim, which=which,
                                      chunk=chunk)
            rr = float(rr_dev)
            if not np.isfinite(rr):
                break  # blew up: keep the best iterate
            # Jacobi-CG on the ill-conditioned fracture operator can
            # plateau for a while mid-convergence, so a single
            # non-halving chunk is not proof of stagnation; require two
            # consecutive ones before giving up (best iterate is kept).
            stalls = stalls + 1 if rr > 0.5 * prev_rr else 0
            if stalls >= 2:
                break
        return state[6], int(state[5])

    du, it_u = run_block("u", rhs_u, Minv_u)
    rhs_p2 = _coupling_rhs(jac_cl, ca, con, active, du, rhs_p, dim=dim)
    dp, it_p = run_block("p", rhs_p2, Minv_p)
    return du, dp, it_u + it_p
