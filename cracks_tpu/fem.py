"""Q1 finite-element tabulation and batched cell geometry.

Replaces deal.II's FEValues machinery (reference cracks.cc:2156-2160)
with dense constant tables: shape values/gradients of the Q1 element at
Gauss quadrature points, evaluated once, plus vectorized per-cell
geometry (Jacobians, JxW, real-space shape gradients) over
``(n_cells, ...)`` arrays.

Vertex ordering is lexicographic on the reference cell [0,1]^dim
(bit d of the local index set <=> reference coordinate d equals 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .meshio import face_vertices

# 3-point Gauss-Legendre on [0,1] — matches QGauss(fe.degree + 2) for
# degree 1 (reference cracks.cc:2156).
_GAUSS3_P = np.array([0.5 - np.sqrt(15.0) / 10.0, 0.5, 0.5 + np.sqrt(15.0) / 10.0])
_GAUSS3_W = np.array([5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0])

_GAUSS2_P = np.array([0.5 - np.sqrt(3.0) / 6.0, 0.5 + np.sqrt(3.0) / 6.0])
_GAUSS2_W = np.array([0.5, 0.5])


def gauss_1d(n: int):
    if n == 2:
        return _GAUSS2_P, _GAUSS2_W
    if n == 3:
        return _GAUSS3_P, _GAUSS3_W
    # general
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def tensor_quadrature(dim: int, n: int = 3):
    """Tensor-product Gauss rule on [0,1]^dim: (points (n^dim, dim), weights)."""
    p1, w1 = gauss_1d(n)
    grids = np.meshgrid(*([p1] * dim), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    wg = np.meshgrid(*([w1] * dim), indexing="ij")
    w = np.ones(len(pts))
    for g in wg:
        w = w * g.ravel()
    return pts, w


def q1_shape_values(points: np.ndarray, dim: int) -> np.ndarray:
    """N_a(xi) for the 2^dim Q1 basis functions; (n_pts, 2^dim)."""
    n = len(points)
    vals = np.ones((n, 2 ** dim))
    for a in range(2 ** dim):
        for d in range(dim):
            xi = points[:, d]
            vals[:, a] *= xi if ((a >> d) & 1) else (1.0 - xi)
    return vals


def q1_shape_grads(points: np.ndarray, dim: int) -> np.ndarray:
    """dN_a/dxi_e at the given points; (n_pts, 2^dim, dim)."""
    n = len(points)
    grads = np.zeros((n, 2 ** dim, dim))
    for a in range(2 ** dim):
        for e in range(dim):
            g = np.ones(n)
            for d in range(dim):
                xi = points[:, d]
                if d == e:
                    g *= 1.0 if ((a >> d) & 1) else -1.0
                else:
                    g *= xi if ((a >> d) & 1) else (1.0 - xi)
            grads[:, a, e] = g
    return grads


@dataclass(frozen=True)
class ElementTables:
    """Constant Q1 tables for one spatial dimension."""

    dim: int
    q_points: np.ndarray     # (n_q, dim)
    q_weights: np.ndarray    # (n_q,)
    shape_v: np.ndarray      # (n_q, 2^dim)
    shape_g: np.ndarray      # (n_q, 2^dim, dim)
    # vertex (Gauss-Lobatto) points for the lumped mass matrix
    vertex_points: np.ndarray    # (2^dim, dim)
    vertex_weights: np.ndarray   # (2^dim,) = (1/2)^dim each
    vertex_shape_g: np.ndarray   # (2^dim, 2^dim, dim) grads at vertices


@lru_cache(maxsize=None)
def element_tables(dim: int, n_gauss: int = 3) -> ElementTables:
    pts, w = tensor_quadrature(dim, n_gauss)
    vp = np.zeros((2 ** dim, dim))
    for a in range(2 ** dim):
        for d in range(dim):
            vp[a, d] = (a >> d) & 1
    return ElementTables(
        dim=dim,
        q_points=pts,
        q_weights=w,
        shape_v=q1_shape_values(pts, dim),
        shape_g=q1_shape_grads(pts, dim),
        vertex_points=vp,
        vertex_weights=np.full(2 ** dim, 0.5 ** dim),
        vertex_shape_g=q1_shape_grads(vp, dim),
    )


# ---------------------------------------------------------------------------
# Face quadrature tables (for boundary loads and COD line integrals,
# reference cracks.cc:3457, 3732: QGauss<dim-1>(3) face rules)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaceTables:
    """Per-face quadrature embedded into the reference cell.

    For each of the 2*dim faces: quadrature points in the dim-dimensional
    reference cell, cell shape values/grads there, plus the face's
    tangent directions in reference space (for the surface Jacobian) and
    the outward reference normal.
    """

    dim: int
    n_q: int
    q_cell_points: np.ndarray   # (n_faces, n_q, dim)
    q_weights: np.ndarray       # (n_q,)
    shape_v: np.ndarray         # (n_faces, n_q, 2^dim)
    shape_g: np.ndarray         # (n_faces, n_q, 2^dim, dim)
    tangent_dims: np.ndarray    # (n_faces, dim-1) int
    normal_sign: np.ndarray     # (n_faces,)  -1 for low faces, +1 for high
    normal_dim: np.ndarray      # (n_faces,) int


@lru_cache(maxsize=None)
def face_tables(dim: int, n_gauss: int = 3) -> FaceTables:
    fpts, fw = tensor_quadrature(dim - 1, n_gauss)
    n_q = len(fpts)
    n_faces = 2 * dim
    cellp = np.zeros((n_faces, n_q, dim))
    tdims = np.zeros((n_faces, dim - 1), dtype=np.int64)
    nsign = np.zeros(n_faces)
    ndim = np.zeros(n_faces, dtype=np.int64)
    for d in range(dim):
        free = [dd for dd in range(dim) if dd != d]
        for side in (0, 1):
            f = 2 * d + side
            cellp[f, :, d] = float(side)
            for k, fd in enumerate(free):
                cellp[f, :, fd] = fpts[:, k]
            tdims[f] = free
            nsign[f] = -1.0 if side == 0 else 1.0
            ndim[f] = d
    sv = np.stack([q1_shape_values(cellp[f], dim) for f in range(n_faces)])
    sg = np.stack([q1_shape_grads(cellp[f], dim) for f in range(n_faces)])
    return FaceTables(
        dim=dim, n_q=n_q, q_cell_points=cellp, q_weights=fw,
        shape_v=sv, shape_g=sg, tangent_dims=tdims,
        normal_sign=nsign, normal_dim=ndim,
    )


# ---------------------------------------------------------------------------
# Batched geometry (host/numpy; the jnp variants live in ops/geometry.py)
# ---------------------------------------------------------------------------

def affine_cell_jacobians(cell_coords: np.ndarray,
                          tables: ElementTables):
    """(detJ_c (n_c,), invJ_c (n_c, dim, dim)) when EVERY cell is
    affine (constant Jacobian — all generated rect/cube meshes and
    their refinements); None when any cell is non-affine (threepoint
    trapezoids).  Host cost is O(n_c dim^2); the big (n_c, n_q, 2^dim,
    dim) gradient tabulation can then run ON DEVICE
    (physics.build_cell_core) so a mesh epoch uploads ~60x less data
    (the grads array is the largest per-epoch upload at 3d production
    sizes)."""
    dim = tables.dim
    X0 = cell_coords[:, 0, :]                       # (c, dim)
    v = np.stack([cell_coords[:, 1 << d, :] - X0 for d in range(dim)],
                 axis=-1)                           # (c, dim(d), dim(e))
    # exact-affinity test: corner a must equal X0 + sum_d bit_d(a) v_d
    # up to rounding of the corner arithmetic itself
    recon = X0[:, None, :] + np.einsum(
        "ae,cde->cad",
        np.array([[(a >> d) & 1 for d in range(dim)]
                  for a in range(2 ** dim)], dtype=np.float64), v)
    scale = np.abs(v).max(axis=(1, 2), keepdims=True)   # (c,1,1)
    affine = (np.abs(recon - cell_coords)
              <= 1e-12 * scale).all(axis=(1, 2))        # (c,)
    if not affine.all():
        return None
    return np.linalg.det(v), np.linalg.inv(v)


def cell_geometry(cell_coords: np.ndarray, tables: ElementTables):
    """Per-cell, per-q-point geometry.

    cell_coords: (n_cells, 2^dim, dim).
    Returns (JxW (n_cells, n_q), grads (n_cells, n_q, 2^dim, dim)) where
    grads are real-space shape gradients dN_a/dx_d.

    Affine cells (parallelograms/parallelepipeds — every generated
    rect/cube production mesh) have a CONSTANT Jacobian J[d,e] = v_e[d]
    with v_e the edge vectors at corner 0, so det/inv run once per cell
    instead of once per (cell, q-point) — ~6x cheaper on the production
    lattice meshes (host geometry is re-evaluated inside every mesh
    epoch's setup).  Mixed meshes (threepoint.msh trapezoids) take the
    generic per-q path for the non-affine cells.
    """
    geo = affine_cell_jacobians(cell_coords, tables)
    if geo is not None:
        detJ_c, invJ_c = geo
        grads = np.einsum("qae,ced->cqad", tables.shape_g, invJ_c)
        JxW = detJ_c[:, None] * tables.q_weights[None, :]
        return JxW, grads

    # J[c,q,d,e] = dx_d / dxi_e = sum_a X[c,a,d] * dN_a/dxi_e (q)
    J = np.einsum("cad,qae->cqde", cell_coords, tables.shape_g)
    detJ = np.linalg.det(J)
    invJ = np.linalg.inv(J)
    # dN_a/dx_d = dN_a/dxi_e * dxi_e/dx_d
    grads = np.einsum("qae,cqed->cqad", tables.shape_g, invJ)
    JxW = detJ * tables.q_weights[None, :]
    return JxW, grads


def lumped_mass_diag(cell_coords: np.ndarray, cell2vert: np.ndarray,
                     n_vertices: int, tables: ElementTables) -> np.ndarray:
    """Gauss-Lobatto lumped (scalar) mass diagonal per vertex
    (reference cracks.cc:2514-2562, assemble_diag_mass_matrix).

    At the vertex quadrature points shape_value(i, q) = delta_iq, so the
    local diagonal is detJ(at vertex i) * (1/2)^dim.
    """
    J = np.einsum("cad,vae->cvde", cell_coords, tables.vertex_shape_g)
    detJ = np.linalg.det(J)
    local = detJ * tables.vertex_weights[None, :]
    diag = np.zeros(n_vertices)
    np.add.at(diag, cell2vert, local)
    return diag
