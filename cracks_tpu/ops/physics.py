"""The quasi-monolithic phase-field fracture element kernel.

Replaces the reference's ``assemble_system`` cell loop
(cracks.cc:2129-2498) with batched dense tensor math — and obtains the
Newton system *matrix-free*: the reference's hand-assembled Jacobian
(cracks.cc:2308-2389) is exactly the derivative of its residual form
(cracks.cc:2393-2430), so the Jacobian action here is ``jax.jvp`` of the
residual and the element matrices (for the direct solver path) are
vmapped ``jax.jacfwd`` of the per-cell residual.

Layout convention: all large arrays keep the **cell axis last** —
``grads`` is ``(n_q, nvc, dim, n_cells)`` — so every contraction is a
small constant matrix times a huge contiguous trailing axis, and the
solution vectors are **flat**: ``u`` is ``(n_v*dim,)`` with dof index
``vertex*dim + component``, ``phi`` is ``(n_v,)``.  Per-quadrature
scalars are ``(n_q, n_cells)``.  Contractions run at
``Precision.HIGHEST`` (``_einsum``), so an f32 build is not silently
evaluated in TF32 on a GPU.

Weak form being discretized (notation of Heister/Wheeler/Wick 2015):

  displacement rows:
      ((1-k) pf_extra^2 + k) sigma+(u) : grad(v)
      + chi_rhs * sigma-(u) : grad(v)
      - (alpha_b - 1) p pf_extra^2 div(v)                [cracks.cc:2404-2410]
  phase-field rows:
      gamma/dt/h^2 max(0, pf - pf_old) w                 [penalized monolithic]
      + (1-k) (sigma+(u) : E(u)) pf w
      - G_c/eps (1 - pf) w
      + G_c eps grad(pf) . grad(w)
      - 2 (alpha_b - 1) p pf div(u) w                    [cracks.cc:2419-2429]

with pf_extra the clamped theta-extrapolation of the two previous time
steps (cracks.cc:2262-2277), alpha_b (Biot) = 0 in all shipped cases
(cracks.cc:1497).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fem import element_tables
from .spectral import stress_split_components

_einsum = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)

ALPHA_BIOT = 0.0  # reference cracks.cc:1497


class ChunkedCells(NamedTuple):
    """Chunk-major copy of the per-cell data for ``lax.scan`` sweeps.

    Every array carries a leading chunk axis: (n_chunks, ..., chunk).
    Padding cells (up to chunk alignment) have JxW = 0 and gather
    indices 0, so they contribute exactly zero (the spectral split is
    zero-strain-safe, spectral.py:88-99)."""

    gather_u: jax.Array   # (n_chunks, nvc*dim, ch) int32
    gather_p: jax.Array   # (n_chunks, nvc, ch) int32
    JxW: jax.Array        # (n_chunks, n_q, ch)
    grads: jax.Array      # (n_chunks, n_q, nvc, dim, ch)
    lam: jax.Array        # (n_chunks, ch)
    mu: jax.Array         # (n_chunks, ch)
    inv_diam2: jax.Array  # (n_chunks, ch)


class CellArrays(NamedTuple):
    """Static per-mesh element data resident on device (cell axis LAST)."""

    gather_u: jax.Array   # (nvc*dim, n_c) int32 — flat u-dof gather map
    gather_p: jax.Array   # (nvc, n_c) int32 — phi-dof gather map
    JxW: jax.Array        # (n_q, n_c)
    grads: jax.Array      # (n_q, nvc, dim, n_c) real-space shape grads
    shape_v: jax.Array    # (n_q, nvc)
    lam: jax.Array        # (n_c,) per-cell Lame lambda
    mu: jax.Array         # (n_c,) per-cell Lame mu
    inv_diam2: jax.Array  # (n_c,) 1/diameter^2 (gamma penalization scaling)
    # chunk-major duplicate for scan-based element sweeps on meshes with
    # > CELL_CHUNK cells (keeps the compiled HLO at one chunk body
    # instead of unrolling n_chunks copies — the Python-unrolled loop
    # made the refine-6 Sneddon kernels take > 1 h to compile)
    chunked: ChunkedCells | None = None


class Scalars(NamedTuple):
    """Per-solve scalars (traced; no recompilation when they change)."""

    pressure: jax.Array        # current pressure p(time)
    constant_k: jax.Array      # regularization k
    alpha_eps: jax.Array       # regularization eps
    G_c: jax.Array             # fracture toughness
    gamma_dt: jax.Array        # gamma_penal / timestep
    theta: jax.Array           # (dt_old + dt_oold)/dt_oold extrapolation factor
    use_old_pf: jax.Array      # 1.0 -> pf_extra := pf_old (retry mode)
    decompose_rhs: jax.Array   # chi for sigma- in the residual


def make_scalars(pressure, constant_k, alpha_eps, G_c, gamma_dt, theta,
                 use_old_pf, decompose_rhs, dtype=jnp.float64) -> Scalars:
    c = lambda v: jnp.asarray(v, dtype=dtype)
    return Scalars(c(pressure), c(constant_k), c(alpha_eps), c(G_c),
                   c(gamma_dt), c(theta), c(use_old_pf), c(decompose_rhs))


def _straight_through_clamp_below(x):
    """max(0, x) in the residual, identity in the linearization.

    The penalized-monolithic mode clamps pf values (cracks.cc:2251-2256)
    but the reference's hand Jacobian linearizes as if d(clamp)/d(pf)=1,
    so the tangent must pass straight through."""
    return x + jax.lax.stop_gradient(jnp.maximum(0.0, x) - x)


def _pf_extra(pf, pf_old, pf_oold, sc: Scalars):
    """Time-lagged extrapolated phase field (cracks.cc:2262-2277)."""
    extra = pf_oold + sc.theta * (pf_old - pf_oold)
    extra = jnp.clip(extra, 0.0, 1.0)
    return jnp.where(sc.use_old_pf > 0.5, pf_old, extra)


def _full_stress_components(strain, lam, mu, dim):
    """sigma = lam tr(E) I + 2 mu E on component dict; strain maps
    (i,j)->(n_q, n_c) arrays for i<=j."""
    tr = sum(strain[(d, d)] for d in range(dim))
    sigma = {}
    for i in range(dim):
        for j in range(i, dim):
            s = 2.0 * mu * strain[(i, j)]
            if i == j:
                s = s + lam * tr
            sigma[(i, j)] = s
    return sigma, tr


def _element_residual_cl(u_e, phi_e, pf_old_e, pf_oold_e, ca: CellArrays,
                         sc: Scalars, *, dim: int, with_split: bool,
                         monolithic: bool):
    """Per-cell residual in the cell-last layout, BEFORE scatter-add.

    u_e (nvc, dim, c); phi_e/pf_old_e/pf_oold_e (nvc, c).
    Returns (ru_e (nvc, dim, c), rp_e (nvc, c)).  Every intermediate
    keeps the cell axis last (huge contiguous trailing axis), which is
    why the element matrices are built from jvps of THIS function
    rather than a vmapped per-cell jacfwd (whose batched tangent axis
    gives intermediates small trailing dimensions).
    """
    # fields at quadrature points — everything (q, ..., c)
    grad_u = _einsum("adc,qaec->qdec", u_e, ca.grads)
    pf = _einsum("qa,ac->qc", ca.shape_v, phi_e)
    grad_pf = _einsum("ac,qaec->qec", phi_e, ca.grads)
    pf_old = _einsum("qa,ac->qc", ca.shape_v, pf_old_e)
    pf_oold = _einsum("qa,ac->qc", ca.shape_v, pf_oold_e)

    if monolithic:
        pf = _straight_through_clamp_below(pf)
        pf_old = jnp.maximum(0.0, pf_old)
        pf_oold = jnp.maximum(0.0, pf_oold)

    pf_extra = _pf_extra(pf, pf_old, pf_oold, sc)

    # symmetric strain components (q, c)
    strain = {}
    for i in range(dim):
        for j in range(i, dim):
            strain[(i, j)] = 0.5 * (grad_u[:, i, j] + grad_u[:, j, i])
    div_u = sum(grad_u[:, d, d] for d in range(dim))

    lam_q = ca.lam[None, :]
    mu_q = ca.mu[None, :]
    if with_split:
        assert dim == 2, "stress decomposition is 2d-only (like the reference)"
        (spxx, spxy, spyy), (smxx, smxy, smyy) = stress_split_components(
            strain[(0, 0)], strain[(0, 1)], strain[(1, 1)], lam_q, mu_q)
        sp = {(0, 0): spxx, (0, 1): spxy, (1, 1): spyy}
        sm = {(0, 0): smxx, (0, 1): smxy, (1, 1): smyy}
        trE = strain[(0, 0)] + strain[(1, 1)]
    else:
        sp, trE = _full_stress_components(strain, lam_q, mu_q, dim)
        sm = {k: jnp.zeros_like(v) for k, v in sp.items()}

    degr = (1.0 - sc.constant_k) * pf_extra**2 + sc.constant_k   # (q, c)
    # M = degr * sigma+ + chi * sigma-  (components, symmetric)
    M = {k: degr * sp[k] + sc.decompose_rhs * sm[k] for k in sp}
    p_term = (ALPHA_BIOT - 1.0) * sc.pressure * pf_extra**2       # (q, c)

    # displacement rows: ru[a,d,c] = -sum_q (sum_e M[d,e] dN_a/dx_e
    #                                        - p_term dN_a/dx_d) JxW
    gw = ca.grads * ca.JxW[:, None, None, :]      # (q, a, e, c)
    ru_e = []
    for d in range(dim):
        acc = 0.0
        for e in range(dim):
            key = (min(d, e), max(d, e))
            acc = acc + _einsum("qc,qac->ac", M[key], gw[:, :, e, :])
        acc = acc - _einsum("qc,qac->ac", p_term, gw[:, :, d, :])
        ru_e.append(-acc)                          # (a, c)
    ru_e = jnp.stack(ru_e, axis=1)                 # (a, d, c)

    # phase-field rows
    sp_E = sum((1.0 if i == j else 2.0) * sp[(i, j)] * strain[(i, j)]
               for i in range(dim) for j in range(i, dim))
    gap_plus = jnp.where(pf - pf_old < 0.0, 0.0, pf - pf_old)
    S = (sc.gamma_dt * ca.inv_diam2[None, :] * gap_plus
         + (1.0 - sc.constant_k) * sp_E * pf
         - sc.G_c / sc.alpha_eps * (1.0 - pf)
         - 2.0 * (ALPHA_BIOT - 1.0) * sc.pressure * pf * div_u)   # (q, c)
    SJ = S * ca.JxW                                               # (q, c)
    rp_e = -(_einsum("qc,qa->ac", SJ, ca.shape_v)
             + sc.G_c * sc.alpha_eps
             * _einsum("qec,qaec->ac", grad_pf, gw))
    return ru_e, rp_e


# Above this many cells the element sweep is processed in sequential
# chunks, which bounds the size of XLA's rematerialized f64 temps.
# The value was sized for a 16 GB device; whether chunking still pays
# on an 80 GB card is an open measurement.  Chunked sweeps run as
# lax.scan over a chunk-major copy of the cell data
# (CellArrays.chunked) so the compiled HLO contains ONE chunk body.
CELL_CHUNK = 131072


def chunk_spec(n_c: int) -> tuple[int, int] | None:
    """(n_chunks, chunk) for a scan sweep, or None if no chunking is
    needed.  The chunk size is lane-aligned (multiple of 128) and the
    chunk count minimal, so padding waste stays small."""
    if n_c <= CELL_CHUNK:
        return None
    n_chunks = -(-n_c // CELL_CHUNK)
    ch = -(-n_c // n_chunks)
    ch = -(-ch // 128) * 128
    return n_chunks, ch


def make_chunked(gather_u, gather_p, JxW, grads, lam, mu, inv_diam2,
                 dtype) -> ChunkedCells | None:
    """Chunk-major device copy of host cell-last arrays (see
    ChunkedCells).  Inputs are numpy, cell axis last."""
    n_c = gather_p.shape[-1]
    spec = chunk_spec(n_c)
    if spec is None:
        return None
    n_chunks, ch = spec

    def prep(a, fill, dt):
        a = np.asarray(a)
        pad = n_chunks * ch - n_c
        if pad:
            a = np.concatenate(
                [a, np.full(a.shape[:-1] + (pad,), fill, a.dtype)],
                axis=-1)
        a = a.reshape(a.shape[:-1] + (n_chunks, ch))
        return jnp.asarray(np.moveaxis(a, -2, 0), dtype=dt)

    return ChunkedCells(
        gather_u=prep(gather_u, 0, jnp.int32),
        gather_p=prep(gather_p, 0, jnp.int32),
        JxW=prep(JxW, 0.0, dtype),
        grads=prep(grads, 0.0, dtype),
        lam=prep(lam, 1.0, dtype),
        mu=prep(mu, 1.0, dtype),
        inv_diam2=prep(inv_diam2, 1.0, dtype))


class CellCore(NamedTuple):
    """Device-resident cell-FIRST geometry core: ONE host->device upload
    per mesh epoch; every CellArrays variant (dtype x cell order x
    chunking — up to three consumers per epoch) derives from it in a
    single jitted device dispatch (derive_cell_arrays).  This keeps the
    per-epoch host work at one geometry sweep and one upload instead of
    three transposing host copies and three uploads."""

    gather_u: jax.Array   # (n_c, nvc*dim) int32
    gather_p: jax.Array   # (n_c, nvc) int32
    JxW: jax.Array        # (n_c, n_q) f64
    grads: jax.Array      # (n_c, n_q, nvc, dim) f64
    lam: jax.Array        # (n_c,) f64
    mu: jax.Array         # (n_c,) f64
    inv_diam2: jax.Array  # (n_c,) f64
    shape_v: np.ndarray   # (n_q, nvc) host-side constant (tiny)


@jax.jit
def _affine_geometry_device(detJ, invJ, shape_g, qw):
    """Device tabulation of (JxW, grads) from per-cell affine
    Jacobians.  For axis-aligned cells invJ is diagonal, so the e-sum
    in the einsum has one nonzero term and the result is bit-identical
    to the host product (adding exact zeros is exact) — golden parity
    is preserved while the upload per mesh epoch drops from the full
    (n_c, n_q, 2^dim, dim) gradient array to O(n_c dim^2)."""
    grads = _einsum("qae,ced->cqad", shape_g, invJ)
    JxW = detJ[:, None] * qw[None, :]
    return JxW, grads


def build_cell_core(mesh, lam, mu) -> CellCore:
    """Host geometry sweep -> device-resident cell-first core.  The
    heavy gradient tabulation runs on device when the mesh is affine
    (every generated rect/cube mesh; see _affine_geometry_device)."""
    from ..fem import affine_cell_jacobians, cell_geometry

    t = element_tables(mesh.dim)
    geo = affine_cell_jacobians(mesh.cell_coords, t)
    if geo is not None:
        detJ_c, invJ_c = geo
        JxW, grads = _affine_geometry_device(
            jnp.asarray(detJ_c), jnp.asarray(invJ_c),
            jnp.asarray(t.shape_g), jnp.asarray(t.q_weights))
    else:
        JxW_h, grads_h = cell_geometry(mesh.cell_coords, t)
        JxW, grads = jnp.asarray(JxW_h), jnp.asarray(grads_h)
    dim = mesh.dim
    n_c = mesh.n_cells
    nvc = mesh.cell2vert.shape[1]
    c2v = mesh.cell2vert.astype(np.int64)
    gather_u = (c2v[:, :, None] * dim
                + np.arange(dim)[None, None, :]).reshape(n_c, nvc * dim)
    lam_arr = np.broadcast_to(np.asarray(lam, np.float64), (n_c,))
    mu_arr = np.broadcast_to(np.asarray(mu, np.float64), (n_c,))
    return CellCore(
        gather_u=jnp.asarray(gather_u, jnp.int32),
        gather_p=jnp.asarray(c2v, jnp.int32),
        JxW=JxW, grads=grads,
        lam=jnp.asarray(lam_arr), mu=jnp.asarray(mu_arr),
        inv_diam2=jnp.asarray(1.0 / mesh.diameters**2),
        shape_v=t.shape_v)


@partial(jax.jit, static_argnames=("dtype", "spec", "permute"))
def _derive_cell_arrays(core: CellCore, perm, *, dtype, spec, permute):
    """One device dispatch: (permute) -> cast -> cell-last transpose
    (-> chunk-major pad/reshape).  Layouts identical to the host
    pipeline (cell_arrays_from_host / make_chunked).

    perm entries < 0 mark DEAD cells (the seam-glued slit lattice pads
    its cell raster with one phantom row, solvers/lattice.py): their
    JxW is zeroed, which zeroes every quadrature contribution — element
    matrices and residuals alike — while the clamped gather indices
    scatter exact zeros."""
    def cf(a):
        a = a[jnp.maximum(perm, 0)] if permute else a
        return a.astype(dtype) if jnp.issubdtype(a.dtype,
                                                 jnp.floating) else a

    firsts = dict(gather_u=cf(core.gather_u), gather_p=cf(core.gather_p),
                  JxW=cf(core.JxW), grads=cf(core.grads),
                  lam=cf(core.lam), mu=cf(core.mu),
                  inv_diam2=cf(core.inv_diam2))
    if permute:
        dead = (perm < 0)[:, None]
        firsts["JxW"] = jnp.where(dead, 0.0, firsts["JxW"])
    last = {k: jnp.moveaxis(a, 0, -1) for k, a in firsts.items()}

    chunked = None
    if spec is not None:
        n_chunks, ch = spec
        n_c = perm.shape[0] if permute else core.JxW.shape[0]
        pad = n_chunks * ch - n_c
        fills = dict(gather_u=0, gather_p=0, JxW=0.0, grads=0.0,
                     lam=1.0, mu=1.0, inv_diam2=1.0)

        def chunk(a, fill):
            a = jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1),
                        constant_values=fill)
            a = a.reshape((n_chunks, ch) + a.shape[1:])
            return jnp.moveaxis(a, 1, -1)

        chunked = ChunkedCells(**{k: chunk(firsts[k], fills[k])
                                  for k in fills})
    return last, chunked


def cell_arrays_from_core(core: CellCore, dtype=jnp.float64,
                          chunk: bool = True,
                          perm: np.ndarray | None = None) -> CellArrays:
    """Device CellArrays (optionally cell-permuted, e.g. into lattice
    raster order) derived from a CellCore."""
    # the permutation may pad the raster (seam lattices add a phantom
    # row, solvers/lattice.py) — chunk the PERMUTED cell count
    n_c = int(len(perm) if perm is not None else core.JxW.shape[0])
    spec = chunk_spec(n_c) if chunk else None
    permute = perm is not None
    perm_d = (jnp.asarray(perm, jnp.int32) if permute
              else jnp.zeros((0,), jnp.int32))
    last, chunked = _derive_cell_arrays(core, perm_d, dtype=dtype,
                                        spec=spec, permute=permute)
    return CellArrays(shape_v=jnp.asarray(core.shape_v, dtype),
                      chunked=chunked, **last)


def _slice_cells(ca: CellArrays, s: int, e: int) -> CellArrays:
    return CellArrays(
        gather_u=ca.gather_u[:, s:e], gather_p=ca.gather_p[:, s:e],
        JxW=ca.JxW[:, s:e], grads=ca.grads[..., s:e],
        shape_v=ca.shape_v, lam=ca.lam[s:e], mu=ca.mu[s:e],
        inv_diam2=ca.inv_diam2[s:e])


def _chunk_cells(ca: CellArrays, c: ChunkedCells) -> CellArrays:
    """CellArrays view of one scanned chunk (shape_v is shared)."""
    return CellArrays(
        gather_u=c.gather_u, gather_p=c.gather_p, JxW=c.JxW,
        grads=c.grads, shape_v=ca.shape_v, lam=c.lam, mu=c.mu,
        inv_diam2=c.inv_diam2)


def _residual_core(u, phi, phi_old, phi_oold, ca: CellArrays, sc: Scalars,
                   *, dim: int, with_split: bool, monolithic: bool):
    """Element residual in cell-last layout.

    Returns (ru (n_v*dim,), rp (n_v,)) — raw scatter-add, no constraints.
    """
    nvc = ca.gather_p.shape[0]
    n_c = ca.gather_p.shape[1]
    n_ud = u.shape[0]
    n_v = phi.shape[0]
    ru = jnp.zeros(n_ud, dtype=u.dtype)
    rp = jnp.zeros(n_v, dtype=u.dtype)

    if ca.chunked is not None:
        def body(carry, c):
            ru_, rp_ = carry
            cac = _chunk_cells(ca, c)
            u_e = u[cac.gather_u].reshape(nvc, dim, -1)
            ru_e, rp_e = _element_residual_cl(
                u_e, phi[cac.gather_p], phi_old[cac.gather_p],
                phi_oold[cac.gather_p], cac, sc, dim=dim,
                with_split=with_split, monolithic=monolithic)
            ru_ = ru_.at[cac.gather_u].add(ru_e.reshape(nvc * dim, -1))
            rp_ = rp_.at[cac.gather_p].add(rp_e)
            return (ru_, rp_), None

        (ru, rp), _ = jax.lax.scan(body, (ru, rp), ca.chunked)
        return ru, rp

    for s in range(0, n_c, CELL_CHUNK):
        e = min(s + CELL_CHUNK, n_c)
        cac = _slice_cells(ca, s, e) if n_c > CELL_CHUNK else ca
        u_e = u[cac.gather_u].reshape(nvc, dim, -1)   # (a, d, c)
        phi_e = phi[cac.gather_p]                     # (a, c)
        ru_e, rp_e = _element_residual_cl(
            u_e, phi_e, phi_old[cac.gather_p], phi_oold[cac.gather_p],
            cac, sc, dim=dim, with_split=with_split,
            monolithic=monolithic)
        ru = ru.at[cac.gather_u].add(ru_e.reshape(nvc * dim, -1))
        rp = rp.at[cac.gather_p].add(rp_e)
    return ru, rp


@partial(jax.jit, static_argnames=("dim", "with_split", "monolithic"))
def assemble_residual(u, phi, phi_old, phi_oold, ca: CellArrays, sc: Scalars,
                      *, dim: int, with_split: bool, monolithic: bool):
    """Global Newton right-hand side (the *negative* residual, matching
    the reference's local_rhs sign convention, cracks.cc:2404/2423)."""
    return _residual_core(u, phi, phi_old, phi_oold, ca, sc, dim=dim,
                          with_split=with_split, monolithic=monolithic)


@partial(jax.jit, static_argnames=("dim", "with_split", "monolithic"))
def jacobian_vector_product(u, phi, du, dphi, phi_old, phi_oold,
                            ca: CellArrays, sc: Scalars,
                            *, dim: int, with_split: bool, monolithic: bool):
    """Action of the Newton system matrix J = -d(rhs)/d(u,phi) on
    (du, dphi) — equals the reference's assembled matrix-vector product
    (cracks.cc:2308-2389) because that matrix is the exact derivative of
    the residual form (see module docstring)."""
    f = lambda uu, pp: _residual_core(
        uu, pp, phi_old, phi_oold, ca, sc,
        dim=dim, with_split=with_split, monolithic=monolithic)
    _, (dru, drp) = jax.jvp(f, (u, phi), (du, dphi))
    return -dru, -drp


def _single_cell_residual(u_e, phi_e, pf_old_e, pf_oold_e, JxW, grads,
                          shape_v, lam, mu, inv_diam2, sc: Scalars,
                          *, dim, with_split, monolithic):
    """Same physics for one cell (small dense arrays; used under
    vmap/jacfwd for the direct-solver element matrices).

    u_e (nvc, dim); phi_e (nvc,); JxW (n_q,); grads (n_q, nvc, dim)."""
    grad_u = _einsum("ad,qae->qde", u_e, grads)
    pf = _einsum("qa,a->q", shape_v, phi_e)
    grad_pf = _einsum("a,qae->qe", phi_e, grads)
    pf_old = _einsum("qa,a->q", shape_v, pf_old_e)
    pf_oold = _einsum("qa,a->q", shape_v, pf_oold_e)
    if monolithic:
        pf = _straight_through_clamp_below(pf)
        pf_old = jnp.maximum(0.0, pf_old)
        pf_oold = jnp.maximum(0.0, pf_oold)
    pf_extra = _pf_extra(pf, pf_old, pf_oold, sc)
    E = 0.5 * (grad_u + jnp.swapaxes(grad_u, -1, -2))
    div_u = jnp.trace(grad_u, axis1=-2, axis2=-1)
    if with_split:
        (spxx, spxy, spyy), (smxx, smxy, smyy) = stress_split_components(
            E[:, 0, 0], E[:, 0, 1], E[:, 1, 1], lam, mu)
        sp = jnp.stack([jnp.stack([spxx, spxy], -1),
                        jnp.stack([spxy, spyy], -1)], -2)
        sm = jnp.stack([jnp.stack([smxx, smxy], -1),
                        jnp.stack([smxy, smyy], -1)], -2)
    else:
        trE = jnp.trace(E, axis1=-2, axis2=-1)
        eye = jnp.eye(dim, dtype=u_e.dtype)
        sp = lam * trE[:, None, None] * eye + 2.0 * mu * E
        sm = jnp.zeros_like(sp)
    degr = (1.0 - sc.constant_k) * pf_extra**2 + sc.constant_k
    M = degr[:, None, None] * sp + sc.decompose_rhs * sm
    p_term = (ALPHA_BIOT - 1.0) * sc.pressure * pf_extra**2
    ru_e = -(_einsum("qde,qae,q->ad", M, grads, JxW)
             - _einsum("q,qad,q->ad", p_term, grads, JxW))
    sp_E = _einsum("qde,qde->q", sp, E)
    gap_plus = jnp.where(pf - pf_old < 0.0, 0.0, pf - pf_old)
    S = (sc.gamma_dt * inv_diam2 * gap_plus
         + (1.0 - sc.constant_k) * sp_E * pf
         - sc.G_c / sc.alpha_eps * (1.0 - pf)
         - 2.0 * (ALPHA_BIOT - 1.0) * sc.pressure * pf * div_u)
    rp_e = -(_einsum("q,qa,q->a", S, shape_v, JxW)
             + sc.G_c * sc.alpha_eps
             * _einsum("qe,qae,q->a", grad_pf, grads, JxW))
    return ru_e, rp_e


def element_matrices_from_cellvals(u_e, phi_e, pf_old_e, pf_oold_e,
                                   cac: CellArrays, sc: Scalars, *,
                                   nvc: int, dim: int, with_split: bool,
                                   monolithic: bool):
    """(ndl, ndl, n_c) dense element Jacobians from PRE-GATHERED per-cell
    dof values (u_e (nvc, dim, n_c), phi_e (nvc, n_c)) via ndl one-hot
    jvps of the batched cell-last residual (see element_matrices
    docstring for why jvps beat a vmapped jacfwd).  Shared by the
    flat gather path below and the gather-free lattice-window path
    (solvers/lattice.py)."""
    ndl = nvc * (dim + 1)
    n_c = phi_e.shape[-1]

    def f(ue, pe):
        ru_e, rp_e = _element_residual_cl(
            ue, pe, pf_old_e, pf_oold_e, cac, sc, dim=dim,
            with_split=with_split, monolithic=monolithic)
        return jnp.concatenate(
            [ru_e.reshape(nvc * dim, n_c), rp_e], axis=0)

    cols = []
    for j in range(ndl):
        if j < nvc * dim:
            a, d = divmod(j, dim)
            tu = jnp.zeros((nvc, dim), u_e.dtype).at[a, d].set(1.0)
            du_t = jnp.broadcast_to(tu[:, :, None], (nvc, dim, n_c))
            dp_t = jnp.zeros((nvc, n_c), u_e.dtype)
        else:
            a = j - nvc * dim
            du_t = jnp.zeros((nvc, dim, n_c), u_e.dtype)
            dp_t = jnp.broadcast_to(
                jnp.zeros(nvc, u_e.dtype).at[a].set(1.0)[:, None],
                (nvc, n_c))
        _, dcol = jax.jvp(f, (u_e, phi_e), (du_t, dp_t))
        cols.append(-dcol)                        # J = -d(rhs)
    return jnp.stack(cols, axis=1)


def _element_matrices_chunk(u, phi, phi_old, phi_oold, cac: CellArrays,
                            sc: Scalars, *, nvc: int, dim: int,
                            with_split: bool, monolithic: bool):
    """(ndl, ndl, n_c) element Jacobians of one cell chunk (flat dof
    vectors, gather maps)."""
    n_c = cac.gather_p.shape[-1]
    return element_matrices_from_cellvals(
        u[cac.gather_u].reshape(nvc, dim, n_c), phi[cac.gather_p],
        phi_old[cac.gather_p], phi_oold[cac.gather_p], cac, sc,
        nvc=nvc, dim=dim, with_split=with_split, monolithic=monolithic)


@partial(jax.jit, static_argnames=("dim", "with_split", "monolithic",
                                   "cell_last"))
def element_matrices(u, phi, phi_old, phi_oold, ca: CellArrays, sc: Scalars,
                     *, dim: int, with_split: bool, monolithic: bool,
                     cell_last: bool = False):
    """Dense element Jacobians J_loc = -d(rhs_loc)/d(x_loc) per cell.

    Local dof ordering: u dofs vertex-major (a*dim+d), then nvc phi dofs.
    With cell_last=False returns (n_cells, ndl, ndl) — consumed by the
    host sparse factorization.  With cell_last=True returns
    (ndl, ndl, n_cells) — the device-resident cell-last layout (see
    module docstring) used by the stored-matrix Krylov
    operator in solvers/assembled.py.

    The cell-last path takes ndl one-hot jvps of the batched cell-last
    element residual instead of one vmapped per-cell jacfwd: the jacfwd
    tangent axis forces (batch, cells, q, ndl, ...) intermediates with
    small trailing dimensions; sequential jvps keep every intermediate
    in the (q, ..., n_cells) layout."""
    nvc = ca.gather_p.shape[0]
    ndl = nvc * (dim + 1)

    if cell_last:
        n_c_all = ca.gather_p.shape[1]
        if ca.chunked is not None:
            def body(_, c):
                return None, _element_matrices_chunk(
                    u, phi, phi_old, phi_oold, _chunk_cells(ca, c), sc,
                    nvc=nvc, dim=dim, with_split=with_split,
                    monolithic=monolithic)

            _, jacs = jax.lax.scan(body, None, ca.chunked)
            # (n_chunks, ndl, ndl, ch) -> (ndl, ndl, n_c)
            jac = jnp.moveaxis(jacs, 0, 2).reshape(ndl, ndl, -1)
            return jac[:, :, :n_c_all]
        chunks = []
        for s in range(0, n_c_all, CELL_CHUNK):
            end = min(s + CELL_CHUNK, n_c_all)
            cac = (_slice_cells(ca, s, end)
                   if n_c_all > CELL_CHUNK else ca)
            chunks.append(_element_matrices_chunk(
                u, phi, phi_old, phi_oold, cac, sc, nvc=nvc, dim=dim,
                with_split=with_split, monolithic=monolithic))
        if len(chunks) == 1:
            return chunks[0]                      # (ndl, ndl, n_c)
        return jnp.concatenate(chunks, axis=2)

    def local(x, pf_old_e, pf_oold_e, JxW, grads, lam, mu, invd2):
        u_e = x[: nvc * dim].reshape(nvc, dim)
        phi_e = x[nvc * dim:]
        ru, rp = _single_cell_residual(
            u_e, phi_e, pf_old_e, pf_oold_e, JxW, grads, ca.shape_v,
            lam, mu, invd2, sc,
            dim=dim, with_split=with_split, monolithic=monolithic)
        return -jnp.concatenate([ru.reshape(-1), rp])

    x_all = jnp.concatenate([u[ca.gather_u], phi[ca.gather_p]], axis=0).T
    jac = jax.vmap(jax.jacfwd(local),
                   in_axes=(0, 1, 1, 1, 3, 0, 0, 0),
                   out_axes=0)(
        x_all, phi_old[ca.gather_p], phi_oold[ca.gather_p], ca.JxW,
        ca.grads, ca.lam, ca.mu, ca.inv_diam2)
    assert jac.shape[-1] == ndl
    return jac


@partial(jax.jit, static_argnames=("dim", "with_split", "monolithic"))
def jacobian_diagonal(u, phi, phi_old, phi_oold, ca: CellArrays, sc: Scalars,
                      *, dim: int, with_split: bool, monolithic: bool):
    """Global diagonal of J (for Jacobi preconditioning of CG)."""
    nvc = ca.gather_p.shape[0]
    jac = element_matrices(u, phi, phi_old, phi_oold, ca, sc,
                           dim=dim, with_split=with_split,
                           monolithic=monolithic)
    d_loc = jnp.diagonal(jac, axis1=-2, axis2=-1).T   # (ndl, n_c)
    du = jnp.zeros(u.shape[0], dtype=u.dtype).at[ca.gather_u].add(
        d_loc[: nvc * dim])
    dp = jnp.zeros(phi.shape[0], dtype=u.dtype).at[ca.gather_p].add(
        d_loc[nvc * dim:])
    return du, dp


@partial(jax.jit, static_argnames=("dim", "monolithic"))
def jacobi_diagonal_approx(u, phi, phi_old, phi_oold, ca: CellArrays,
                           sc: Scalars, *, dim: int, monolithic: bool):
    """Cheap analytic Jacobi diagonal for preconditioning the CG path.

    Uses the *undecomposed* elastic operator for the displacement block
    (the split only redistributes stiffness between the +/- parts, so
    this stays spectrally equivalent) and the exact reaction/diffusion
    terms for the phase-field block.  Computed entirely in the cell-last
    layout — unlike element_matrices, no vmapped jacfwd, so it scales to
    millions of cells."""
    nvc = ca.gather_p.shape[0]
    phi_e = phi[ca.gather_p]
    pf = _einsum("qa,ac->qc", ca.shape_v, phi_e)
    pf_old = _einsum("qa,ac->qc", ca.shape_v, phi_old[ca.gather_p])
    pf_oold = _einsum("qa,ac->qc", ca.shape_v, phi_oold[ca.gather_p])
    if monolithic:
        pf = jnp.maximum(0.0, pf)
        pf_old = jnp.maximum(0.0, pf_old)
        pf_oold = jnp.maximum(0.0, pf_oold)
    pf_extra = _pf_extra(pf, pf_old, pf_oold, sc)
    degr = (1.0 - sc.constant_k) * pf_extra**2 + sc.constant_k   # (q, c)

    u_e = u[ca.gather_u].reshape(nvc, dim, -1)
    grad_u = _einsum("adc,qaec->qdec", u_e, ca.grads)
    div_u = sum(grad_u[:, d, d] for d in range(dim))
    strain = {}
    for i in range(dim):
        for j in range(i, dim):
            strain[(i, j)] = 0.5 * (grad_u[:, i, j] + grad_u[:, j, i])
    sp, _tr = _full_stress_components(strain, ca.lam[None, :],
                                      ca.mu[None, :], dim)
    sp_E = sum((1.0 if i == j else 2.0) * sp[(i, j)] * strain[(i, j)]
               for i in range(dim) for j in range(i, dim))

    gw = ca.grads * ca.JxW[:, None, None, :]          # (q, a, e, c)
    g2 = _einsum("qaec,qaec->qac", ca.grads, gw)   # sum_e (dN)^2 * JxW
    # u diagonal per (a, d): (lam+mu) (dN_d)^2 + mu |grad N|^2, degraded
    du_ad = []
    for d in range(dim):
        gd2 = ca.grads[:, :, d, :] * gw[:, :, d, :]
        term = ((ca.lam + ca.mu)[None, None, :] * gd2
                + ca.mu[None, None, :] * g2)
        du_ad.append(_einsum("qc,qac->ac", degr, term))
    du_e = jnp.stack(du_ad, axis=1).reshape(nvc * dim, -1)

    gap_pos = jnp.where(pf - pf_old < 0.0, 0.0, 1.0)
    react = ((1.0 - sc.constant_k) * sp_E
             + sc.G_c / sc.alpha_eps
             + sc.gamma_dt * ca.inv_diam2[None, :] * gap_pos
             - 2.0 * (ALPHA_BIOT - 1.0) * sc.pressure * div_u)  # (q, c)
    NN = ca.shape_v * ca.shape_v                       # (q, a)
    dp_e = (_einsum("qc,qa,qc->ac", react, NN, ca.JxW)
            + sc.G_c * sc.alpha_eps * _einsum("qac->ac", g2))

    du = jnp.zeros(u.shape[0], dtype=u.dtype).at[ca.gather_u].add(du_e)
    dp = jnp.zeros(phi.shape[0], dtype=u.dtype).at[ca.gather_p].add(dp_e)
    return du, dp


def build_cell_arrays_host(mesh, lam, mu):
    """Host (numpy) per-cell geometry tables, cell axis last.

    Returns (gather_u, gather_p, JxW, grads, shape_v, lam, mu,
    inv_diam2) as numpy arrays — the common precursor of
    build_cell_arrays and the lattice's raster-permuted variant (which
    must permute on host BEFORE any device transfer)."""
    from ..fem import cell_geometry

    t = element_tables(mesh.dim)
    JxW, grads = cell_geometry(mesh.cell_coords, t)   # (c, q), (c, q, a, d)
    dim = mesh.dim
    n_c = mesh.n_cells
    nvc = mesh.cell2vert.shape[1]
    c2v = mesh.cell2vert.astype(np.int64)
    gather_u = (c2v[:, :, None] * dim
                + np.arange(dim)[None, None, :]).reshape(n_c, nvc * dim).T
    gather_p = c2v.T
    lam_arr = np.broadcast_to(np.asarray(lam, dtype=np.float64), (n_c,))
    mu_arr = np.broadcast_to(np.asarray(mu, dtype=np.float64), (n_c,))
    return (gather_u, gather_p, JxW.T, np.transpose(grads, (1, 2, 3, 0)),
            t.shape_v, lam_arr, mu_arr, 1.0 / mesh.diameters**2)


def cell_arrays_from_host(host, dtype=jnp.float64,
                          chunk: bool = True) -> CellArrays:
    """Device CellArrays from build_cell_arrays_host output."""
    (gather_u, gather_p, JxW_T, grads_T, shape_v, lam_arr, mu_arr,
     inv_diam2) = host
    chunked = None
    if chunk:
        chunked = make_chunked(gather_u, gather_p, JxW_T, grads_T,
                               lam_arr, mu_arr, inv_diam2, dtype)
    return CellArrays(
        gather_u=jnp.asarray(gather_u, dtype=jnp.int32),
        gather_p=jnp.asarray(gather_p, dtype=jnp.int32),
        JxW=jnp.asarray(JxW_T, dtype=dtype),
        grads=jnp.asarray(grads_T, dtype=dtype),
        shape_v=jnp.asarray(shape_v, dtype=dtype),
        lam=jnp.asarray(lam_arr, dtype=dtype),
        mu=jnp.asarray(mu_arr, dtype=dtype),
        inv_diam2=jnp.asarray(inv_diam2, dtype=dtype),
        chunked=chunked,
    )


def build_cell_arrays(mesh, lam, mu, dtype=jnp.float64,
                      chunk: bool = True) -> CellArrays:
    """Precompute the per-cell geometry tables for a MeshData (host).

    With chunk=True (default) and > CELL_CHUNK cells, a chunk-major
    duplicate (CellArrays.chunked) is attached for scan-based element
    sweeps; pass chunk=False for cell arrays that will be sharded across
    devices (the SPMD path splits the cell axis itself)."""
    return cell_arrays_from_host(build_cell_arrays_host(mesh, lam, mu),
                                 dtype=dtype, chunk=chunk)
