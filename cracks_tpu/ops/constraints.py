"""Constraint handling: hanging nodes, Dirichlet masks, active-set masks.

Replaces deal.II AffineConstraints (reference cracks.cc:1630-1642,
2439-2464).  Solution layout is flat: u is (n_v*dim,) with dof index
vertex*dim + component, phi is (n_v,) (see ops/physics.py
docstring).

All constraints in the Newton update system are homogeneous (the
reference's inhomogeneous initial boundary values are written into the
solution directly by set_initial_bc, cracks.cc:2699-2707), so

 * distribute  == set children from masters, zero the masked dofs
 * distribute_local_to_global residual == scatter, then add each hanging
   child's residual row to its masters and zero the child
 * set_zero    == zero all constrained rows.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Constraints(NamedTuple):
    """Device-side constraint data (flat dof indexing).

    The hanging arrays exist in two flavors: per-phi-vertex and expanded
    per-u-dof (each vertex constraint applies to every component).
    """

    hang_child_p: jax.Array    # (n_h,) int32 phi dofs
    hang_masters_p: jax.Array  # (n_h, 4) int32
    hang_child_u: jax.Array    # (n_h*dim,) int32 u dofs
    hang_masters_u: jax.Array  # (n_h*dim, 4) int32
    hang_weights: jax.Array    # (n_h, 4)
    hang_weights_u: jax.Array  # (n_h*dim, 4)
    dirichlet_u: jax.Array     # (n_v*dim,) bool
    dirichlet_p: jax.Array     # (n_v,) bool
    hang_mask_u: jax.Array     # (n_v*dim,) bool
    hang_mask_p: jax.Array     # (n_v,) bool


def make_constraints(mesh, dirichlet_u: np.ndarray, dirichlet_p: np.ndarray,
                     dtype=jnp.float64) -> Constraints:
    """dirichlet_u: (n_v, dim) bool vertex/component mask."""
    dim = mesh.dim
    n_v = mesh.n_vertices
    child = mesh.hang_child.astype(np.int64)
    masters = mesh.hang_masters.astype(np.int64)
    weights = mesh.hang_weights
    comp = np.arange(dim)
    child_u = (child[:, None] * dim + comp[None, :]).reshape(-1)
    masters_u = (masters[:, None, :] * dim
                 + comp[None, :, None]).reshape(-1, masters.shape[1])
    weights_u = np.repeat(weights, dim, axis=0)
    hm_p = np.zeros(n_v, dtype=bool)
    hm_p[child] = True
    hm_u = np.zeros(n_v * dim, dtype=bool)
    hm_u[child_u] = True
    return Constraints(
        hang_child_p=jnp.asarray(child, dtype=jnp.int32),
        hang_masters_p=jnp.asarray(masters, dtype=jnp.int32),
        hang_child_u=jnp.asarray(child_u, dtype=jnp.int32),
        hang_masters_u=jnp.asarray(masters_u, dtype=jnp.int32),
        hang_weights=jnp.asarray(weights, dtype=dtype),
        hang_weights_u=jnp.asarray(weights_u, dtype=dtype),
        dirichlet_u=jnp.asarray(np.asarray(dirichlet_u).reshape(-1), dtype=bool),
        dirichlet_p=jnp.asarray(dirichlet_p, dtype=bool),
        hang_mask_u=jnp.asarray(hm_u, dtype=bool),
        hang_mask_p=jnp.asarray(hm_p, dtype=bool),
    )


def _interp(x, child, masters, weights):
    vals = jnp.einsum("hm,hm->h", weights, x[masters])
    return x.at[child].set(vals)


def _transpose(r, child, masters, weights):
    child_vals = r[child]
    r = r.at[masters].add(weights * child_vals[:, None])
    return r.at[child].set(0.0)


@jax.jit
def hanging_interpolate_u(x, con: Constraints):
    return _interp(x, con.hang_child_u, con.hang_masters_u, con.hang_weights_u)


@jax.jit
def hanging_interpolate_p(x, con: Constraints):
    return _interp(x, con.hang_child_p, con.hang_masters_p, con.hang_weights)


@jax.jit
def hanging_transpose_u(r, con: Constraints):
    return _transpose(r, con.hang_child_u, con.hang_masters_u,
                      con.hang_weights_u)


@jax.jit
def hanging_transpose_p(r, con: Constraints):
    return _transpose(r, con.hang_child_p, con.hang_masters_p,
                      con.hang_weights)


@jax.jit
def zero_constrained(ru, rp, con: Constraints, active):
    """constraints.set_zero on the (u, phi) residual pair; `active` is
    the active-set mask over phase-field vertices (n_v,)."""
    ru = jnp.where(con.dirichlet_u | con.hang_mask_u, 0.0, ru)
    rp = jnp.where(con.dirichlet_p | con.hang_mask_p | active, 0.0, rp)
    return ru, rp


@jax.jit
def condense_residual(ru, rp, con: Constraints, active):
    """Full reduction of a raw assembled residual to the Newton system
    right-hand side: hanging condensation then zeroing of all
    constrained rows (cracks.cc:2442-2443 + set_zero 2918)."""
    ru = hanging_transpose_u(ru, con)
    rp = hanging_transpose_p(rp, con)
    return zero_constrained(ru, rp, con, active)


@jax.jit
def expand_update(du, dp, con: Constraints, active):
    """Map a free-dof update into the full space: zero constrained dofs,
    then interpolate hanging children (constraints.distribute on the
    homogeneous Newton update, cracks.cc:2756/2773)."""
    du, dp = zero_constrained(du, dp, con, active)
    du = hanging_interpolate_u(du, con)
    dp = hanging_interpolate_p(dp, con)
    return du, dp


def residual_norm(ru, rp) -> jax.Array:
    """l2 norm over the combined (u, phi) residual."""
    return jnp.sqrt(jnp.sum(ru * ru) + jnp.sum(rp * rp))


def residual_linfty(ru, rp) -> jax.Array:
    return jnp.maximum(jnp.max(jnp.abs(ru)), jnp.max(jnp.abs(rp)))
