"""Quantities of interest / postprocessing functionals.

Reimplements the reference's N15 component (cracks.cc:3264-3816):
bulk/crack energies, boundary load, total crack volume, crack opening
displacements, point stress and the Sneddon exact-phi L2 error.

Two tiers: host-numpy reference implementations (readable, what the
unit tests pin against, used for the small/occasional functionals), and
device-side jitted reductions for the per-step energy/TCV/stationarity
evaluations, which at refine-6 sizes would otherwise cost seconds per
step in host geometry sweeps and device-to-host transfers.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .fem import (cell_geometry, element_tables, face_tables,
                  q1_shape_grads, q1_shape_values)
from .mesh import MeshData


def _fields_at_qpoints(mesh: MeshData, u, phi):
    """(grad_u, pf, grad_pf, JxW, qx) at the cell Gauss points."""
    t = element_tables(mesh.dim)
    JxW, grads = cell_geometry(mesh.cell_coords, t)
    u_e = u[mesh.cell2vert]
    phi_e = phi[mesh.cell2vert]
    grad_u = np.einsum("cad,cqae->cqde", u_e, grads)
    pf = np.einsum("qa,ca->cq", t.shape_v, phi_e)
    grad_pf = np.einsum("ca,cqad->cqd", phi_e, grads)
    u_q = np.einsum("qa,cad->cqd", t.shape_v, u_e)
    qx = np.einsum("qa,cad->cqd", t.shape_v, mesh.cell_coords)
    return grad_u, pf, grad_pf, u_q, JxW, qx


def compute_energy(mesh: MeshData, u, phi, lam_cells, mu_cells,
                   constant_k: float, alpha_eps: float, G_c: float):
    """Bulk and crack energies (cracks.cc:3615-3701).

    bulk  = ((1+k) pf^2 + k) psi(e)      [note (1+k), reference quirk]
    crack = G_c/2 ((pf-1)^2/eps + eps |grad pf|^2)
    """
    grad_u, pf, grad_pf, _, JxW, _ = _fields_at_qpoints(mesh, u, phi)
    E = 0.5 * (grad_u + np.swapaxes(grad_u, -1, -2))
    trE = np.trace(E, axis1=-2, axis2=-1)
    trE2 = np.einsum("cqde,cqed->cq", E, E)
    psi = (0.5 * lam_cells[:, None] * trE**2 + mu_cells[:, None] * trE2)
    bulk = np.sum(((1 + constant_k) * pf**2 + constant_k) * psi * JxW)
    crack = np.sum(0.5 * G_c * ((pf - 1) ** 2 / alpha_eps
                                + alpha_eps * (grad_pf ** 2).sum(-1)) * JxW)
    return float(bulk), float(crack)


def compute_tcv(mesh: MeshData, u, phi):
    """Total crack volume TCV = int u . grad(pf) dx (cracks.cc:3553-3589)."""
    _, _, grad_pf, u_q, JxW, _ = _fields_at_qpoints(mesh, u, phi)
    return float(np.sum(np.einsum("cqd,cqd->cq", u_q, grad_pf) * JxW))


# ---------------------------------------------------------------------------
# device-side QoI reductions (the per-step hot path)
#
# compute_energy/compute_tcv above are the readable host-numpy reference
# implementations (and what the unit tests pin against).  The driver's
# per-step statistics call runs on DEVICE instead: at refine-6 sizes the
# host path re-derives the (c, q, a, dim) geometry tables on the host
# and pulls the solution vectors off the device, all inside the benched
# region — while the device kernel reuses the resident CellArrays and
# returns three f64 scalars.  Same integrals as cracks.cc:3615-3701 / 3553-3589.
# ---------------------------------------------------------------------------

def _energy_tcv_cl(u_e, phi_e, lam, mu, JxW, grads, shape_v,
                   constant_k, alpha_eps, G_c, dim):
    """Chunk body, cell-last layout (mirrors physics._element_residual_cl):
    u_e (a, d, c), phi_e (a, c), lam/mu (c,), JxW (q, c),
    grads (q, a, d, c).  Returns (bulk, crack, tcv) partial sums."""
    import jax.numpy as jnp

    grad_u = jnp.einsum("adc,qaec->qdec", u_e, grads)
    pf = jnp.einsum("qa,ac->qc", shape_v, phi_e)
    grad_pf = jnp.einsum("ac,qaec->qec", phi_e, grads)
    u_q = jnp.einsum("qa,adc->qdc", shape_v, u_e)
    trE = sum(grad_u[:, d, d] for d in range(dim))
    E2 = 0.0
    for d in range(dim):
        for e in range(dim):
            Ede = 0.5 * (grad_u[:, d, e] + grad_u[:, e, d])
            E2 = E2 + Ede * Ede
    psi = 0.5 * lam[None, :] * trE**2 + mu[None, :] * E2
    bulk = jnp.sum(((1.0 + constant_k) * pf**2 + constant_k) * psi * JxW)
    crack = jnp.sum(0.5 * G_c * ((pf - 1.0) ** 2 / alpha_eps
                                 + alpha_eps * jnp.sum(grad_pf**2, axis=1))
                    * JxW)
    tcv = jnp.sum(jnp.einsum("qdc,qdc->qc", u_q, grad_pf) * JxW)
    return bulk, crack, tcv


def energy_tcv_device(u, phi, ca, lam_e, mu_e, constant_k, alpha_eps,
                      G_c, *, dim: int):
    """Jitted device evaluation of (bulk energy, crack energy, TCV).

    `ca` is the System's device CellArrays (f64, assembly cell order,
    chunked at > CELL_CHUNK cells); `lam_e`/`mu_e` are the ENERGY
    Lame fields as (n_c,) device arrays — for the heterogeneous case
    they use the raw bitmap E without the assembly's +1 offset
    (reference quirk, cracks.cc:3651)."""
    return _energy_tcv_device_jit(u, phi, ca, lam_e, mu_e,
                                  jnp.asarray(constant_k, jnp.float64),
                                  jnp.asarray(alpha_eps, jnp.float64),
                                  jnp.asarray(G_c, jnp.float64), dim=dim)


@partial(jax.jit, static_argnames=("dim",))
def _energy_tcv_device_jit(u, phi, ca, lam_e, mu_e, constant_k,
                           alpha_eps, G_c, *, dim):
    from .ops.physics import CELL_CHUNK, _chunk_cells, _slice_cells

    nvc = ca.gather_p.shape[0]
    n_c = ca.gather_p.shape[1]
    if lam_e.shape[0] != n_c:
        # multi-chip CellArrays carry zero-JxW pad cells (so the pad
        # value is irrelevant to the integrals); match their length
        lam_e = jnp.pad(lam_e, (0, n_c - lam_e.shape[0]))
        mu_e = jnp.pad(mu_e, (0, n_c - mu_e.shape[0]))
    if ca.chunked is not None:
        # chunk the energy Lame fields to the scan layout (pad cells
        # carry JxW == 0, so the fill value is irrelevant)
        n_chunks, ch = ca.chunked.JxW.shape[0], ca.chunked.JxW.shape[-1]
        pad = n_chunks * ch - n_c

        def chunk_vec(a):
            return jnp.pad(a, (0, pad)).reshape(n_chunks, ch)

        lam_c, mu_c = chunk_vec(lam_e), chunk_vec(mu_e)

        def body(carry, xs):
            c, lam_k, mu_k = xs
            cac = _chunk_cells(ca, c)
            u_e = u[cac.gather_u].reshape(nvc, dim, -1)
            b, cr, t = _energy_tcv_cl(
                u_e, phi[cac.gather_p], lam_k, mu_k, cac.JxW, cac.grads,
                cac.shape_v, constant_k, alpha_eps, G_c, dim)
            b0, c0, t0 = carry
            return (b0 + b, c0 + cr, t0 + t), None

        z = jnp.zeros((), jnp.float64)
        (bulk, crack, tcv), _ = jax.lax.scan(
            body, (z, z, z), (ca.chunked, lam_c, mu_c))
        return bulk, crack, tcv

    bulk = crack = tcv = jnp.zeros((), jnp.float64)
    for s in range(0, n_c, CELL_CHUNK):
        e = min(s + CELL_CHUNK, n_c)
        cac = _slice_cells(ca, s, e) if n_c > CELL_CHUNK else ca
        u_e = u[cac.gather_u].reshape(nvc, dim, -1)
        b, cr, t = _energy_tcv_cl(
            u_e, phi[cac.gather_p], lam_e[s:e], mu_e[s:e], cac.JxW,
            cac.grads, cac.shape_v, constant_k, alpha_eps, G_c, dim)
        bulk, crack, tcv = bulk + b, crack + cr, tcv + t
    return bulk, crack, tcv


@jax.jit
def linf_diff_device(u, u_old, phi, phi_old):
    """max(‖u − u_old‖_∞, ‖φ − φ_old‖_∞) in one device dispatch — the
    Sneddon stationarity criterion (cracks.cc:4483-4489) without pulling
    four full solution vectors to the host every step."""
    du = jnp.max(jnp.abs(u - u_old))
    dp = jnp.max(jnp.abs(phi - phi_old))
    return jnp.maximum(du, dp)


def tcv_exact(dim: int, pressure: float, poisson_nu: float) -> float:
    """Sneddon closed-form reference volume (cracks.cc:3591-3602)."""
    l0, E = 1.0, 1.0
    if dim == 2:
        return 2.0 * pressure * l0**2 * (1 - poisson_nu**2) * np.pi / E
    return 16.0 * pressure * l0**3 * (1 - poisson_nu**2) / E / 3.0


def _face_geometry(mesh: MeshData, cells, faces):
    """Face-quadrature geometry for (cell, local face) pairs.

    Returns (shape_v (n,q,a), grad_real (n,q,a,dim), normals (n,q,dim),
    JxW_face (n,q), qx (n,q,dim))."""
    ft = face_tables(mesh.dim)
    X = mesh.cell_coords[cells]                       # (n, nvc, dim)
    sv = ft.shape_v[faces]                            # (n, q, a)
    sg = ft.shape_g[faces]                            # (n, q, a, dim)
    J = np.einsum("nad,nqae->nqde", X, sg)            # (n,q,dim,dim)
    invJ = np.linalg.inv(J)
    grad_real = np.einsum("nqae,nqed->nqad", sg, invJ)
    qx = np.einsum("nqa,nad->nqd", sv, X)

    dim = mesh.dim
    tan_dims = ft.tangent_dims[faces]                 # (n, dim-1)
    if dim == 2:
        tang = J[np.arange(len(cells))[:, None, None],
                 np.arange(ft.n_q)[None, :, None],
                 np.arange(dim)[None, None, :],
                 tan_dims[:, None, None, 0]]
        surf = np.linalg.norm(tang, axis=-1)          # (n, q)
    else:
        t1 = J[np.arange(len(cells))[:, None, None],
               np.arange(ft.n_q)[None, :, None],
               np.arange(dim)[None, None, :],
               tan_dims[:, None, None, 0]]
        t2 = J[np.arange(len(cells))[:, None, None],
               np.arange(ft.n_q)[None, :, None],
               np.arange(dim)[None, None, :],
               tan_dims[:, None, None, 1]]
        surf = np.linalg.norm(np.cross(t1, t2), axis=-1)
    JxW_f = surf * ft.q_weights[None, :]

    # outward normal: sign * J^{-T} e_d normalized
    nd = ft.normal_dim[faces]
    ns = ft.normal_sign[faces]
    normal = invJ[np.arange(len(cells))[:, None, None],
                  np.arange(ft.n_q)[None, :, None],
                  nd[:, None, None],
                  np.arange(dim)[None, None, :]]
    normal = normal / np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal * ns[:, None, None]
    return sv, grad_real, normal, JxW_f, qx


def compute_load(mesh: MeshData, u, lam_cells, mu_cells, boundary_id=3):
    """Boundary traction integral int sigma(u) n ds over the faces with
    the given boundary id (cracks.cc:3728-3789).  Returns the raw load
    vector (before the test-case-specific sign flips)."""
    sel = mesh.bface_id == boundary_id
    cells = mesh.bface_cell[sel]
    faces = mesh.bface_face[sel]
    if len(cells) == 0:
        return np.zeros(mesh.dim)
    sv, grad_real, normal, JxW_f, _ = _face_geometry(mesh, cells, faces)
    u_e = u[mesh.cell2vert[cells]]
    grad_u = np.einsum("nad,nqae->nqde", u_e, grad_real)
    E = 0.5 * (grad_u + np.swapaxes(grad_u, -1, -2))
    trE = np.trace(E, axis1=-2, axis2=-1)
    lam = lam_cells[cells][:, None]
    mu = mu_cells[cells][:, None]
    eye = np.eye(mesh.dim)
    sigma = (lam[..., None, None] * trE[..., None, None] * eye
             + 2 * mu[..., None, None] * E)
    traction = np.einsum("nqde,nqe->nqd", sigma, normal)
    load = np.einsum("nqd,nq->d", traction, JxW_f)
    load[0] *= -1.0  # cracks.cc:3789
    return load


def compute_cod(mesh: MeshData, u, phi, eval_line: float):
    """Crack opening displacement: line integral (1/2) int u . grad(pf)
    over the cell faces perpendicular to x at x = eval_line, halved for
    double-counting (cracks.cc:3451-3549).  Returns -1e300 when no face
    matches (the reference's sentinel)."""
    dim = mesh.dim
    eps = 1e-8
    centers = mesh.cell_coords.mean(axis=1)
    near = ~((centers[:, 0] - mesh.diameters > eval_line)
             | (centers[:, 0] + mesh.diameters < eval_line))
    cand = np.where(near)[0]
    if len(cand) == 0:
        return -1e300
    # faces 0 and 1 are the x-normal faces of each cell
    cells = np.repeat(cand, 2)
    faces = np.tile(np.array([0, 1], dtype=np.int32), len(cand))
    sv, grad_real, normal, JxW_f, qx = _face_geometry(mesh, cells, faces)
    on_line = np.abs(qx[:, 0, 0] - eval_line) < eps
    if not on_line.any():
        return -1e300
    cells, faces = cells[on_line], faces[on_line]
    sv, grad_real, JxW_f = sv[on_line], grad_real[on_line], JxW_f[on_line]
    u_e = u[mesh.cell2vert[cells]]
    phi_e = phi[mesh.cell2vert[cells]]
    u_q = np.einsum("nqa,nad->nqd", sv, u_e)
    grad_pf = np.einsum("na,nqad->nqd", phi_e, grad_real)
    cod = 0.5 * np.einsum("nqd,nqd->", u_q * JxW_f[..., None], grad_pf)
    return float(cod / 2.0)


def compute_cod_array(mesh: MeshData, u, phi, n_buckets: int = 75,
                      n_iter: int = 100):
    """Bucketed COD profile over x in [-1.5, 1.5] using an iterated
    midpoint rule (cracks.cc:3323-3449).  Returns (x, values, exact).

    Matches the reference's QIterated(QMidpoint, 100) resolution in 2d
    (n_iter midpoints per axis), processing cells in chunks to bound
    memory; 3d keeps a reduced rule (the reference only evaluates this
    for the 2d Sneddon benchmark)."""
    x1, x2 = -1.5, 1.5
    n1 = n_iter if mesh.dim == 2 else min(n_iter, 20)
    axis = (np.arange(n1) + 0.5) / n1
    grids = np.meshgrid(*([axis] * mesh.dim), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    wq = np.full(len(pts), 1.0 / len(pts))
    sv = q1_shape_values(pts, mesh.dim)
    sg = q1_shape_grads(pts, mesh.dim)
    values = np.zeros(n_buckets)
    width = (x2 - x1) / n_buckets
    # only cells overlapping the sweep window contribute
    lo = mesh.cell_coords[..., 0].min(axis=1)
    hi = mesh.cell_coords[..., 0].max(axis=1)
    cand = np.where((hi >= x1 - width) & (lo <= x2 + width))[0]
    chunk = max(1, 2 ** 22 // max(len(pts), 1))
    for s in range(0, len(cand), chunk):
        sel = cand[s:s + chunk]
        X = mesh.cell_coords[sel]
        J = np.einsum("cad,qae->cqde", X, sg)
        detJ = np.linalg.det(J)
        invJ = np.linalg.inv(J)
        grads = np.einsum("qae,cqed->cqad", sg, invJ)
        JxW = detJ * wq[None, :]
        qx = np.einsum("qa,cad->cqd", sv, X)
        u_q = np.einsum("qa,cad->cqd", sv, u[mesh.cell2vert[sel]])
        grad_pf = np.einsum("ca,cqad->cqd", phi[mesh.cell2vert[sel]], grads)
        cod_q = np.einsum("cqd,cqd->cq", u_q, grad_pf) * JxW
        idx = np.floor((qx[..., 0] - x1) / (x2 - x1) * n_buckets
                       + 0.5).astype(int)
        valid = (idx >= 0) & (idx < n_buckets)
        np.add.at(values, idx[valid], cod_q[valid])
    values = values / width / 2.0
    xs = x1 + np.arange(n_buckets) * width
    exact = 1.92e-3 * np.sqrt(np.maximum(0.0, 1.0 - xs**2))
    return xs, values, exact


def compute_cod_sweep(mesh: MeshData, u, phi, lines: np.ndarray,
                      eps: float = 1e-8):
    """COD at MANY x-lines in one batched pass (the full 769-line
    cod-NNb.txt sweep, cracks.cc:3704-3725).

    One face-geometry pass over all x-normal faces computes each face's
    COD contribution; per line the answer is a bincount over faces
    whose constant x-coordinate matches.  Returns an array of COD
    values with the reference's -1e300 sentinel where no face lies on
    the line."""
    lines = np.asarray(lines, dtype=np.float64)
    n_c = mesh.n_cells
    cells = np.repeat(np.arange(n_c), 2)
    faces = np.tile(np.array([0, 1], dtype=np.int32), n_c)
    sv, grad_real, _, JxW_f, qx = _face_geometry(mesh, cells, faces)
    fx = qx[:, 0, 0]                                  # faces are x-const
    u_e = u[mesh.cell2vert[cells]]
    phi_e = phi[mesh.cell2vert[cells]]
    u_q = np.einsum("nqa,nad->nqd", sv, u_e)
    grad_pf = np.einsum("na,nqad->nqd", phi_e, grad_real)
    contrib = 0.5 * np.einsum("nqd,nqd->n", u_q * JxW_f[..., None],
                              grad_pf)
    # match faces to lines: both sorted, pair within eps
    order = np.argsort(fx)
    fxs = fx[order]
    cs = contrib[order]
    left = np.searchsorted(fxs, lines - eps, side="left")
    right = np.searchsorted(fxs, lines + eps, side="right")
    csum = np.concatenate([[0.0], np.cumsum(cs)])
    vals = (csum[right] - csum[left]) / 2.0
    return np.where(right > left, vals, -1e300)


def sneddon_exact_phi(points: np.ndarray, alpha_eps: float) -> np.ndarray:
    """Sneddon closed-form phase field 1 - exp(-dist/eps) at arbitrary
    points, dist = distance to the slit [-1,1] x {0} (cracks.cc:417-455)."""
    points = np.asarray(points)
    xx = points[..., 0]
    dist_interior = (np.abs(points[..., 1]) if points.shape[-1] == 2
                     else np.sqrt(points[..., 1] ** 2 + points[..., 2] ** 2))
    left = points.copy()
    left[..., 0] = -1.0
    left[..., 1:] = 0.0
    right = left.copy()
    right[..., 0] = 1.0
    d_left = np.linalg.norm(points - left, axis=-1)
    d_right = np.linalg.norm(points - right, axis=-1)
    dist = np.where(xx < -1.0, d_left,
                    np.where(xx > 1.0, d_right, dist_interior))
    return 1.0 - np.exp(-dist / alpha_eps)


def sneddon_phi_l2_error(mesh: MeshData, phi, alpha_eps: float):
    """|| phi - phi_exact ||_L2 with the Sneddon closed-form phase field
    (cracks.cc:417-455, 4495-4524)."""
    t = element_tables(mesh.dim)
    JxW, _ = cell_geometry(mesh.cell_coords, t)
    qx = np.einsum("qa,cad->cqd", t.shape_v, mesh.cell_coords)
    pf = np.einsum("qa,ca->cq", t.shape_v, phi[mesh.cell2vert])
    exact = sneddon_exact_phi(qx, alpha_eps)
    return float(np.sqrt(np.sum((pf - exact) ** 2 * JxW)))


def compute_point_stress(mesh: MeshData, u, point=(0.0, 2.0)):
    """-du_y/dy at the given point (three-point bending,
    cracks.cc:3285-3320)."""
    pt = np.asarray(point)
    lo = mesh.cell_coords.min(axis=1)
    hi = mesh.cell_coords.max(axis=1)
    inside = ((pt >= lo - 1e-12) & (pt <= hi + 1e-12)).all(axis=1)
    cells = np.where(inside)[0]
    if len(cells) == 0:
        return -1e100
    c = cells[0]
    X = mesh.cell_coords[c]
    # invert the bilinear map by Newton (quads here are axis-aligned or
    # mildly distorted; a few iterations suffice)
    xi = np.full(mesh.dim, 0.5)
    for _ in range(20):
        svs = q1_shape_values(xi[None], mesh.dim)[0]
        sgs = q1_shape_grads(xi[None], mesh.dim)[0]
        r = svs @ X - pt
        Jm = X.T @ sgs
        xi = xi - np.linalg.solve(Jm, r)
        xi = np.clip(xi, 0.0, 1.0)
    sgs = q1_shape_grads(xi[None], mesh.dim)[0]
    Jm = X.T @ sgs
    grads = sgs @ np.linalg.inv(Jm)
    grad_u = np.einsum("ad,ae->de", u[mesh.cell2vert[c]], grads)
    return float(-grad_u[1][1])


def compute_point_value(mesh: MeshData, field, point, component=None):
    """Evaluate a nodal field at a point (cracks.cc:3264-3283)."""
    pt = np.asarray(point)
    lo = mesh.cell_coords.min(axis=1)
    hi = mesh.cell_coords.max(axis=1)
    inside = ((pt >= lo - 1e-12) & (pt <= hi + 1e-12)).all(axis=1)
    cells = np.where(inside)[0]
    if len(cells) == 0:
        return -1e100
    c = cells[0]
    X = mesh.cell_coords[c]
    xi = np.full(mesh.dim, 0.5)
    for _ in range(20):
        svs = q1_shape_values(xi[None], mesh.dim)[0]
        sgs = q1_shape_grads(xi[None], mesh.dim)[0]
        r = svs @ X - pt
        Jm = X.T @ sgs
        xi = xi - np.linalg.solve(Jm, r)
        xi = np.clip(xi, 0.0, 1.0)
    svs = q1_shape_values(xi[None], mesh.dim)[0]
    vals = field[mesh.cell2vert[c]]
    out = svs @ vals
    if component is not None and np.ndim(out) > 0:
        return float(out[component])
    return out
