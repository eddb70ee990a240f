"""Galerkin (element-RAP) geometric multigrid on stored element matrices.

The reference preconditions GMRES with Trilinos ML — *algebraic*
multigrid whose aggregation reads the matrix entries and therefore sees
the fracture's degraded coefficient (cracks.cc:2477-2497).  Round 1's
geometric V-cycle rediscretized coarse operators from restricted state,
which misrepresents the 1-2-cell-wide crack strip (full-weighting turns
a ~1e-9 coefficient into ~0.25) and stalled on fracture steps
(solvers/multigrid.py docstring).

This module gets the reference's coefficient awareness the array-native
way: **Galerkin coarse operators assembled element-wise on device**.
For nested Q1 spaces, a coarse basis function restricted to a child
cell is a fixed linear combination of the child's basis functions, so

    A_coarse[parent] = sum_children  P_pos^T  A_fine[child]  P_pos

with 2^dim constant (ndl x ndl) embedding matrices P_pos (plus identity
for pass-through leaves of the truncated forest).  The coarse element
matrices inherit the fine coefficients *exactly* — the crack strip's
tiny entries survive to every level, so the coarse correction never
injects energy into the crack.  All levels then share the stored-matrix
machinery of solvers/assembled.py: batched dense matvecs, exact
diagonals, Chebyshev smoothing, and a dense Cholesky on the coarsest
level (the Amesos-direct analogue, cracks.cc:2750-2758).

Hanging nodes (adaptive meshes): the element-RAP stays cell-local by
coarsening the RAW (unconstrained) nodal operators — raw Q1 spaces nest
exactly, so the coarse element matrices still inherit the fine
coefficients — and applying each level's hanging-node condensation in
the OPERATOR, not the matrices:

    A_l^cond x = mask . H_l^T  A_l^raw  H_l . mask x

with H_l the level's hanging interpolation (children from masters).
This is deal.II's level-matrices-with-level-constraints construction
(MGConstrainedDoFs) expressed as gather/scatter wrappers around the
stored-element-matrix matvec; the coarsest dense factor condenses with
a dense constraint matrix.  Adaptive hierarchies (predictor-corrector
runs, cracks.cc:4419-4431) therefore get the same coefficient-exact
GMG as uniform ones.
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh import Forest, MeshData, interpolation_stencil
from ..ops import physics
from . import assembled
from .multigrid import _chebyshev, _prolong, _restrict


# ---------------------------------------------------------------------------
# host-side hierarchy construction (per mesh epoch)
# ---------------------------------------------------------------------------

def _rows_view(*cols):
    a = np.ascontiguousarray(np.stack([c.astype(np.int64) for c in cols],
                                      axis=1))
    return a.view([("", np.int64)] * a.shape[1]).ravel()


def cell_parent_map(coarse_f: Forest, fine_f: Forest):
    """For each fine-forest cell: (parent cell index in the coarse
    forest, position code).  Position 0..2^dim-1 identifies which child
    octant; 2^dim means pass-through (the cell exists on both levels)."""
    dim = coarse_f.dim
    ckeys = _rows_view(coarse_f.root, coarse_f.level, *coarse_f.anchor.T)
    order = np.argsort(ckeys)
    csorted = ckeys[order]

    fkeys_self = _rows_view(fine_f.root, fine_f.level, *fine_f.anchor.T)
    pos_self = np.searchsorted(csorted, fkeys_self)
    pos_self_c = np.minimum(pos_self, len(csorted) - 1)
    found_self = csorted[pos_self_c] == fkeys_self

    lvl_p = np.maximum(fine_f.level - 1, 0)
    Wp = (fine_f.S >> lvl_p).astype(np.int64)
    anchor_p = (fine_f.anchor // Wp[:, None]) * Wp[:, None]
    fkeys_par = _rows_view(fine_f.root, lvl_p, *anchor_p.T)
    pos_par = np.searchsorted(csorted, fkeys_par)
    pos_par_c = np.minimum(pos_par, len(csorted) - 1)
    found_par = csorted[pos_par_c] == fkeys_par
    if not (found_self | found_par).all():
        raise RuntimeError("fine forest is not a one-level refinement of "
                           "the coarse forest")

    parent = np.where(found_self, order[pos_self_c], order[pos_par_c])
    Wf = (fine_f.S >> fine_f.level).astype(np.int64)
    child_bits = (fine_f.anchor // Wf[:, None]) & 1
    pos_code = np.zeros(len(parent), dtype=np.int64)
    for d in range(dim):
        pos_code |= child_bits[:, d] << d
    pos_code = np.where(found_self, 2 ** dim, pos_code)
    return parent.astype(np.int64), pos_code


def embedding_matrices(dim: int) -> np.ndarray:
    """(2^dim + 1, ndl, ndl) local embedding P_pos with
    P[a_fine_local_dof, b_coarse_local_dof]; the last entry is the
    identity (pass-through cells)."""
    nvc = 2 ** dim
    ndl = nvc * (dim + 1)
    out = np.zeros((nvc + 1, ndl, ndl))
    for pos in range(nvc):
        Ps = np.zeros((nvc, nvc))
        for a in range(nvc):
            w = 1.0
            row = np.ones(nvc)
            for d in range(dim):
                x = (((pos >> d) & 1) + ((a >> d) & 1)) / 2.0
                for b in range(nvc):
                    row[b] *= x if ((b >> d) & 1) else (1.0 - x)
            Ps[a] = row
        P = np.zeros((ndl, ndl))
        for a in range(nvc):
            for b in range(nvc):
                for d in range(dim):
                    P[a * dim + d, b * dim + d] = Ps[a, b]
                P[nvc * dim + a, nvc * dim + b] = Ps[a, b]
        out[pos] = P
    out[nvc] = np.eye(ndl)
    return out


class GLevel(NamedTuple):
    """Static per-level data (device arrays; rebuilt per mesh epoch)."""

    gather_u: jax.Array        # (nvc*dim, n_c) int32
    gather_p: jax.Array        # (nvc, n_c) int32
    dirichlet_u: jax.Array     # (n_ud,) bool
    dirichlet_p: jax.Array     # (n_p,) bool
    inject_p: jax.Array        # (n_p,) int32 — level vertex -> fine vertex
    # coarsening from the NEXT-FINER level:
    fine_idx: jax.Array        # (n_cf,) int32 — finer-level cell ids
    parent_idx: jax.Array      # (n_cf,) int32 — this level's cell ids
    pos_code: jax.Array        # (n_cf,) int32
    # prolongation stencils INTO the next-finer level:
    up_masters_p: jax.Array    # (n_p_finer, 2^dim) int32
    up_weights_p: jax.Array
    up_masters_u: jax.Array
    up_weights_u: jax.Array
    # this level's hanging-node constraints (empty arrays when the
    # level mesh is conforming)
    con: object


class GalerkinHierarchy(NamedTuple):
    levels: tuple              # coarsest ... finest-1 (GLevel)
    P_embed: jax.Array         # (2^dim + 1, ndl, ndl)
    dim: int


def build_galerkin_hierarchy(forest: Forest, fine_mesh: MeshData,
                             dirichlet_fn, dtype=jnp.float64,
                             min_coarse_vertices: int = 400):
    """Construct the Galerkin GMG hierarchy for the current forest.

    Returns None when no usable coarsening exists.  Meshes with hanging
    nodes (fine or level) are supported: each level carries its own
    constraint bundle, applied in the level operators (module
    docstring)."""
    from ..ops.constraints import make_constraints

    dim = fine_mesh.dim
    lmax = int(forest.level.max())
    chain = []  # (forest, mesh) coarse -> fine-1
    for l in range(lmax):
        f_l = forest.truncated(l)
        if f_l.n_cells == forest.n_cells:
            break
        m_l = f_l.extract()
        if chain and m_l.n_vertices == chain[-1][1].n_vertices:
            continue
        chain.append((f_l, m_l))
    # drop tiny duplicate coarse levels below the dense-solve threshold
    while len(chain) > 1 and chain[1][1].n_vertices < min_coarse_vertices:
        chain.pop(0)
    if not chain:
        return None

    comp = np.arange(dim)
    levels = []
    fine_keys = fine_mesh.vertex_keys
    for i, (f_l, m_l) in enumerate(chain):
        finer_f = chain[i + 1][0] if i + 1 < len(chain) else forest
        finer_m = chain[i + 1][1] if i + 1 < len(chain) else fine_mesh
        parent, pos_code = cell_parent_map(f_l, finer_f)
        masters, weights = interpolation_stencil(f_l, m_l, finer_m)
        m_u = (masters.astype(np.int64)[:, None, :] * dim
               + comp[None, :, None]).reshape(-1, masters.shape[1])
        w_u = np.repeat(weights, dim, axis=0)
        mask_u, mask_p = dirichlet_fn(m_l)
        pos = np.searchsorted(fine_keys, m_l.vertex_keys)
        if not (fine_keys[np.minimum(pos, len(fine_keys) - 1)]
                == m_l.vertex_keys).all():
            return None
        c2v = m_l.cell2vert.astype(np.int64)
        nvc = 2 ** dim
        gu = (c2v[:, :, None] * dim
              + np.arange(dim)[None, None, :]).reshape(-1, nvc * dim).T
        levels.append(GLevel(
            gather_u=jnp.asarray(gu, jnp.int32),
            gather_p=jnp.asarray(c2v.T, jnp.int32),
            dirichlet_u=jnp.asarray(np.asarray(mask_u).reshape(-1)),
            dirichlet_p=jnp.asarray(mask_p),
            inject_p=jnp.asarray(pos, jnp.int32),
            fine_idx=jnp.asarray(np.arange(finer_f.n_cells), jnp.int32),
            parent_idx=jnp.asarray(parent, jnp.int32),
            pos_code=jnp.asarray(pos_code, jnp.int32),
            up_masters_p=jnp.asarray(masters, jnp.int32),
            up_weights_p=jnp.asarray(weights, dtype),
            up_masters_u=jnp.asarray(m_u, jnp.int32),
            up_weights_u=jnp.asarray(w_u, dtype),
            con=make_constraints(m_l, np.asarray(mask_u),
                                 np.asarray(mask_p), dtype=dtype)))
    return GalerkinHierarchy(
        levels=tuple(levels),
        P_embed=jnp.asarray(embedding_matrices(dim), dtype),
        dim=dim)


# ---------------------------------------------------------------------------
# device-side: coarse matrices, V-cycle, CG
# ---------------------------------------------------------------------------

def coarsen_level(jac_finer, lvl: GLevel, P_embed, n_coarse_cells: int):
    """A_l = sum P_pos^T A_{l+1} P_pos, batched over cells."""
    ndl = jac_finer.shape[0]
    P_embed = P_embed.astype(jac_finer.dtype)
    P = P_embed[lvl.pos_code]                      # (n_cf, ndl, ndl)
    A = jac_finer[:, :, lvl.fine_idx]              # (ndl, ndl, n_cf)
    # Precision.HIGHEST: successive reduced-precision RAPs can corrupt
    # the coarse chain into indefiniteness (lattice.py coarsen).  Runs
    # once per Newton solve.
    C = jnp.einsum("nai,abn,nbj->ijn", P, A, P,
                   precision=jax.lax.Precision.HIGHEST)
    out = jnp.zeros((ndl, ndl, n_coarse_cells), jac_finer.dtype)
    return out.at[:, :, lvl.parent_idx].add(C)


class _LevelOps(NamedTuple):
    jac: jax.Array
    gather_u: jax.Array
    gather_p: jax.Array
    free_u: jax.Array
    free_p: jax.Array
    Dinv_u: jax.Array
    Dinv_p: jax.Array
    lam_u: jax.Array
    lam_p: jax.Array
    up_masters_u: jax.Array
    up_weights_u: jax.Array
    up_masters_p: jax.Array
    up_weights_p: jax.Array
    # hanging-node stencils of THIS level, per block (possibly empty);
    # weights cast to the jac dtype
    hang_u: tuple              # (child, masters, weights)
    hang_p: tuple
    rng: jax.Array             # Chebyshev smoothing range for this op


def _matvec(jac, gather, x, lo, hi):
    xe = x[gather]
    ye = jnp.einsum("ijc,jc->ic", jac[lo:hi, lo:hi], xe,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.zeros_like(x).at[gather].add(ye)


def _hinterp(x, hang):
    """x with hanging children set from masters (H x)."""
    child, masters, weights = hang
    vals = jnp.einsum("hm,hm->h", weights.astype(x.dtype), x[masters])
    return x.at[child].set(vals)


def _htranspose(r, hang):
    """H^T r: child rows distributed to masters, children zeroed."""
    child, masters, weights = hang
    vals = r[child]
    r = r.at[masters].add(weights.astype(r.dtype) * vals[:, None])
    return r.at[child].set(0.0)


def _hang_of(con, which):
    if which == "u":
        return (con.hang_child_u, con.hang_masters_u, con.hang_weights_u)
    return (con.hang_child_p, con.hang_masters_p, con.hang_weights)


def _masked_op(jac, gather, free, lo, hi, hang=None):
    """Condensed masked block operator: mask . H^T A_raw H . mask
    (H = identity when hang is None/empty — conforming level)."""
    def op(x):
        x = jnp.where(free, x, 0.0)
        if hang is not None:
            x = _hinterp(x, hang)
        y = _matvec(jac, gather, x, lo, hi)
        if hang is not None:
            y = _htranspose(y, hang)
        return jnp.where(free, y, 0.0)
    return op


def _gershgorin_lambda_max(jac, gather, free, Dinv, lo, hi, hang=None):
    """Deterministic upper bound on lambda_max(D^{-1} A): the Gershgorin
    row-sum bound max_i sum_j |A_ij| / d_i, with the row sums
    over-approximated element-wise (triangle inequality over cells).
    An UPPER bound is essential here: Chebyshev smoothing AMPLIFIES
    modes above its assumed spectrum edge, and a power-iteration
    estimate can sit below lambda_max when the dominant mode is
    localized in the degraded crack strip (observed: 1.54 vs 2.18 on
    the fracture u-block, which made the V-cycle divergent).

    With hanging constraints, rows of the condensed operator H^T A H
    pick up child-row contributions scaled by the (nonnegative) Q1
    weights; |H|^T applied to the raw row sums over-approximates them."""
    rs = jnp.sum(jnp.abs(jac[lo:hi, lo:hi]), axis=1)        # (b, c)
    s = jnp.zeros_like(Dinv).at[gather].add(rs)
    if hang is not None:
        child, masters, weights = hang
        s = s.at[masters].add(jnp.abs(weights.astype(s.dtype))
                              * s[child][:, None])
    return jnp.max(jnp.where(free, s * jnp.abs(Dinv), 0.0))


def _lambda_est(jac, gather, free, Dinv, lo, hi, hang=None,
                sharp: bool = False):
    """lambda_max(D^{-1} A) for the Chebyshev smoother.  With sharp
    (the production spectral-window regime, multigrid.sharp_spectrum):
    an m-step Lanczos estimate — immune to the localized-crack-strip
    failure that rules out plain power iteration, see
    _gershgorin_lambda_max's docstring — capped by the deterministic
    Gershgorin bound (pure safety: a Ritz value cannot exceed the true
    lambda_max, which Gershgorin bounds from above), falling back to
    Gershgorin when the Lanczos readout is non-finite (empty free
    sets).  Without sharp: the Gershgorin bound (golden-size regime)."""
    ger = _gershgorin_lambda_max(jac, gather, free, Dinv, lo, hi, hang)
    if not sharp:
        return ger
    from .multigrid import lanczos_lambda_max
    # symmetrized operator (J + J^T)/2: with the spectral split in the
    # matrix the u block is nonsymmetric, and Lanczos on the symmetric
    # part bounds the real field of values — the quantity the Chebyshev
    # window must cover.  H^T A^T H is reached by transposing the
    # element matrices (the gather/scatter structure is self-adjoint).
    op = _masked_op(jac, gather, free, lo, hi, hang)
    opT = _masked_op(jnp.swapaxes(jac, 0, 1), gather, free, lo, hi,
                     hang)
    lam = lanczos_lambda_max(lambda x: 0.5 * (op(x) + opT(x)), Dinv,
                             free)
    ok = jnp.isfinite(lam) & (lam > 0)
    return jnp.where(ok, jnp.minimum(lam, ger), ger)


def _level_geom(levels, ca_fine, con_f, i, *, dim: int):
    """(gather_u, gather_p, con, n_ud, n_p) of level i (i == len(levels)
    is the finest mesh)."""
    if i == len(levels):
        n_ud = int(con_f.dirichlet_u.shape[0])
        n_p = int(con_f.dirichlet_p.shape[0])
        return ca_fine.gather_u, ca_fine.gather_p, con_f, n_ud, n_p
    lvl = levels[i]
    n_p = int(lvl.dirichlet_p.shape[0])
    return lvl.gather_u, lvl.gather_p, lvl.con, n_p * dim, n_p


def _level_blockdata(jacs, levels, ca_fine, con_f, active, which, *,
                     dim: int, sharp: bool):
    """(free, Dinv, lam) per level, coarsest..finest, for ONE block.
    The u-block data is independent of the active set (free_u is the
    Dirichlet/hanging mask only), which is what lets solve_split cache
    it across the PDAS tail together with the RAP chain."""
    nvc = 2 ** dim
    nud_l = nvc * dim
    lo, hi = (0, nud_l) if which == "u" else (nud_l, nud_l + nvc)
    out = []
    for i in range(len(levels) + 1):
        jac = jacs[i]
        gather_u, gather_p, con, n_ud, n_p = _level_geom(
            levels, ca_fine, con_f, i, dim=dim)
        if which == "u":
            free = ~(con.dirichlet_u | con.hang_mask_u)
            gather = gather_u
        else:
            act_l = (active if i == len(levels)
                     else active[levels[i].inject_p])
            free = ~(con.dirichlet_p | con.hang_mask_p | act_l)
            gather = gather_p
        hang = _hang_of(con, which)
        du, dp = assembled.diagonals(
            jac, _GatherView(gather_u, gather_p), n_ud, n_p, dim=dim)
        d = du if which == "u" else dp
        Dinv = jnp.where(free & (jnp.abs(d) > 0), 1.0 / d, 1.0)
        lam = _lambda_est(jac, gather, free, Dinv, lo, hi, hang,
                          sharp=sharp)
        out.append((free, Dinv, lam))
    return tuple(out)


def build_level_ops(hier: GalerkinHierarchy, jac_fine, ca_fine, active,
                    con_f, *, dim: int, sharp: bool = False,
                    reuse=None):
    """Per-level operator data, coarsest..finest, for both blocks.
    con_f is the finest mesh's Constraints bundle.  sharp selects the
    spectral-window regime (multigrid.sharp_spectrum policy).

    Returns (level_ops, reuse_out) where reuse_out = (jacs, u_data) —
    the RAP chain and the u-block masks/diagonals/spectra, both
    independent of the active set.  Passing it back as `reuse` on a
    later call with the SAME element matrices skips the coarsening and
    the u-side Lanczos: only the p-block (whose free set carries the
    active-set mask) is rebuilt.  This is the Galerkin analogue of the
    lattice split-solve's u-levels cache (lattice._solve_split)."""
    from .multigrid import smoothing_range
    rng = jnp.asarray(smoothing_range(sharp), jac_fine.dtype)
    levels = hier.levels
    if reuse is None:
        # coarsen matrices top-down
        jacs = [jac_fine]
        for lvl in reversed(levels):
            n_cc = int(lvl.gather_p.shape[1])
            jacs.insert(0, coarsen_level(jacs[0], lvl, hier.P_embed,
                                         n_cc))
        jacs = tuple(jacs)
        u_data = _level_blockdata(jacs, levels, ca_fine, con_f, active,
                                  "u", dim=dim, sharp=sharp)
    else:
        jacs, u_data = reuse
    p_data = _level_blockdata(jacs, levels, ca_fine, con_f, active,
                              "p", dim=dim, sharp=sharp)

    out = []
    for i in range(len(levels) + 1):
        fin = i == len(levels)
        jac = jacs[i]
        gather_u, gather_p, con, _n_ud, _n_p = _level_geom(
            levels, ca_fine, con_f, i, dim=dim)
        free_u, Dinv_u, lam_u = u_data[i]
        free_p, Dinv_p, lam_p = p_data[i]
        lvl = None if fin else levels[i]
        out.append(_LevelOps(
            jac, gather_u, gather_p, free_u, free_p, Dinv_u, Dinv_p,
            lam_u, lam_p,
            None if fin else lvl.up_masters_u,
            None if fin else lvl.up_weights_u.astype(jac.dtype),
            None if fin else lvl.up_masters_p,
            None if fin else lvl.up_weights_p.astype(jac.dtype),
            _hang_of(con, "u"), _hang_of(con, "p"), rng))
    return tuple(out), (jacs, u_data)


class _GatherView(NamedTuple):
    """Duck-typed stand-in for CellArrays where only the gather maps are
    needed (assembled.diagonals)."""
    gather_u: jax.Array
    gather_p: jax.Array


def make_vcycle(level_ops: tuple, *, dim: int, which: str,
                degree: int = 2):
    """V-cycle application M^{-1} b for one block over the Galerkin
    hierarchy; exact arithmetic analogue of multigrid.make_vcycle with
    a dense Cholesky coarsest solve."""
    nvc = 2 ** dim
    nud_l = nvc * dim
    lo, hi = (0, nud_l) if which == "u" else (nud_l, nud_l + nvc)
    L = len(level_ops)

    def level_pieces(l):
        lv = level_ops[l]
        gather = lv.gather_u if which == "u" else lv.gather_p
        free = lv.free_u if which == "u" else lv.free_p
        Dinv = lv.Dinv_u if which == "u" else lv.Dinv_p
        lam = lv.lam_u if which == "u" else lv.lam_p
        hang = lv.hang_u if which == "u" else lv.hang_p
        op = _masked_op(lv.jac, gather, free, lo, hi, hang)
        return lv, gather, free, Dinv, lam, op, hang

    # coarsest dense factor (built lazily on first call inside jit trace)
    lv0, gather0, free0, Dinv0, lam0, op0, hang0 = level_pieces(0)
    n0 = free0.shape[0]

    def coarse_dense():
        # assemble dense A0 from element matrices
        g = gather0
        ndl_b = hi - lo
        A = lv0.jac[lo:hi, lo:hi]                     # (b, b, c)
        rows = jnp.broadcast_to(g[:, None, :], (ndl_b, ndl_b, g.shape[1]))
        cols = jnp.broadcast_to(g[None, :, :], (ndl_b, ndl_b, g.shape[1]))
        A0 = jnp.zeros((n0, n0), lv0.jac.dtype)
        A0 = A0.at[rows.reshape(-1), cols.reshape(-1)].add(A.reshape(-1))
        m = free0
        # condense hanging constraints with a dense C (rows: children
        # from masters; constrained columns dropped), then identity on
        # constrained dofs
        child0, masters0, weights0 = hang0
        if child0.shape[0]:
            C = jnp.diag(m.astype(A0.dtype))
            C = C.at[child0[:, None], masters0].add(
                weights0.astype(A0.dtype))
            C = C * m[None, :].astype(A0.dtype)
            A0 = C.T @ (A0 @ C)
        A0 = jnp.where(m[:, None] & m[None, :], A0, 0.0)
        A0 = A0 + jnp.diag(jnp.where(m, 0.0, 1.0))
        # The degraded crack strip gives A0 a coefficient contrast of
        # ~1/k (1e8-1e9).  A float32 Cholesky of that breaks down
        # (garbage/NaN factors -> indefinite preconditioner -> CG
        # stalls), so factor the Jacobi-SCALED matrix in float64
        # whatever the V-cycle dtype; the coarsest level is tiny.
        A0 = A0.astype(jnp.float64)
        s = 1.0 / jnp.sqrt(jnp.abs(jnp.diagonal(A0)))
        A0s = A0 * s[:, None] * s[None, :]
        # SPD-safety shift against f32 chain rounding (see lattice.py
        # _coarse_dense_factor); preconditioner-only, 1e-5 of the unit
        # diagonal
        A0s = A0s + 1e-5 * jnp.eye(A0s.shape[0], dtype=A0s.dtype)
        return jax.scipy.linalg.cho_factor(A0s), s

    cho, cho_scale = coarse_dense()

    def cycle(l, b):
        lv, gather, free, Dinv, lam, op, hang = level_pieces(l)
        b = jnp.where(free, b, 0.0)
        if l == 0:
            bs = cho_scale * b.astype(jnp.float64)
            x = (cho_scale * jax.scipy.linalg.cho_solve(cho, bs)
                 ).astype(b.dtype)
            return jnp.where(free, x, 0.0)
        x = _chebyshev(op, Dinv, b, lam, degree, rng=lv.rng)
        r = b - op(x)
        lvc = level_ops[l - 1]
        mast = lvc.up_masters_u if which == "u" else lvc.up_masters_p
        wts = lvc.up_weights_u if which == "u" else lvc.up_weights_p
        hang_c = lvc.hang_u if which == "u" else lvc.hang_p
        n_c = (lvc.free_u if which == "u" else lvc.free_p).shape[0]
        # restriction through the coarse level's constraints: the
        # transpose of (distribute on coarse, then interpolate up)
        r_c = _htranspose(_restrict(r, mast, wts, n_c), hang_c)
        e_c = cycle(l - 1, r_c)
        e_full = _hinterp(e_c, hang_c)
        x = x + jnp.where(free, _prolong(e_full, mast, wts), 0.0)
        r = b - op(x)
        x = x + _chebyshev(op, Dinv, r, lam, degree, rng=lv.rng)
        return x

    return lambda b: cycle(L - 1, b)


# ---------------------------------------------------------------------------
# fully fused Newton-system solve (ONE device dispatch)
# ---------------------------------------------------------------------------
#
# The chunked host-driven solve costs ~15 host round trips per Newton
# iteration.  This entry traces the WHOLE solve — float64
# element-Jacobian build, float32 cast, Galerkin coarsening, both block
# solves with restarted refinement passes — as one XLA computation.

@partial(jax.jit, static_argnames=("dim", "with_split", "monolithic",
                                   "degree", "inner_max", "passes"))
def solve_newton_system(u, phi, phi_old, phi_oold, ca64, sc, levels,
                        P_embed, con, active, rhs_u, rhs_p, rtol,
                        reuse=None, *, dim: int, with_split: bool,
                        monolithic: bool, degree: int = 2,
                        inner_max: int = 64, passes: int = 3):
    """Returns (du, dp, iters, rnorm2, reuse_out) on the free subspace.

    `reuse` (optional) is a previous call's reuse_out — the RAP chain
    (incl. the fine f32 element matrices) and the u-block level data,
    both active-set independent.  The f64 Newton operator is ALWAYS
    linearized fresh at (u, phi) and drives the between-pass residuals,
    so a reused (slightly stale, <= 1e-6 relative) f32 chain changes
    only preconditioner quality, never the computed solution beyond
    solver tolerance.  The caller gates reuse on the production-size
    regime (newton._solve_assembled).

    Krylov iterations run ENTIRELY in float32 (stored element matrices +
    Galerkin V-cycle); float64 appears only in the exact residuals
    between restarted refinement passes, computed MATRIX-FREE via one
    linearized jvp application per pass instead of stored float64
    element matrices (12 f64 jvp-grade build passes)."""
    from ..ops.constraints import (condense_residual, expand_update)

    f32c = lambda x: x.astype(jnp.float32)
    if reuse is None:
        ca32 = physics.CellArrays(
            gather_u=ca64.gather_u, gather_p=ca64.gather_p,
            JxW=f32c(ca64.JxW), grads=f32c(ca64.grads),
            shape_v=f32c(ca64.shape_v), lam=f32c(ca64.lam),
            mu=f32c(ca64.mu), inv_diam2=f32c(ca64.inv_diam2))
        sc32 = physics.Scalars(*(f32c(v) for v in sc))
        jac32 = physics.element_matrices(
            f32c(u), f32c(phi), f32c(phi_old), f32c(phi_oold), ca32,
            sc32, dim=dim, with_split=with_split,
            monolithic=monolithic, cell_last=True)
    else:
        jac32 = reuse[0][-1]   # fine level of the cached RAP chain

    # float64 Newton operator, matrix-free: linearize once at the
    # Newton point, apply per refinement pass (J = -d(rhs)/dx)
    def res64(uu, pp):
        return physics.assemble_residual(
            uu, pp, phi_old, phi_oold, ca64, sc,
            dim=dim, with_split=with_split, monolithic=monolithic)

    _, jvp64 = jax.linearize(res64, u, phi)

    def op64_both(xu, xp):
        """Condensed f64 action on free-subspace (xu, xp): returns
        (J_uu xu, J_pu xu + J_pp xp) condensed."""
        eu, ep = expand_update(xu, xp, con, active)
        ju, jp = jvp64(eu, ep)
        return condense_residual(-ju, -jp, con, active)

    hier = GalerkinHierarchy(levels=levels, P_embed=P_embed, dim=dim)
    from .multigrid import sharp_spectrum
    level_ops, reuse_out = build_level_ops(
        hier, jac32, ca64, active, con, dim=dim,
        sharp=sharp_spectrum(int(active.shape[0]) * (dim + 1)),
        reuse=reuse)
    nvc = 2 ** dim
    nud_l = nvc * dim
    eps64 = float(jnp.finfo(jnp.float64).eps)
    zero_u = jnp.zeros_like(rhs_u)
    zero_p = jnp.zeros_like(rhs_p)

    def block_solve(which, b):
        lo, hi = (0, nud_l) if which == "u" else (nud_l, nud_l + nvc)
        fin = level_ops[-1]
        gather = fin.gather_u if which == "u" else fin.gather_p
        free = fin.free_u if which == "u" else fin.free_p
        hang = fin.hang_u if which == "u" else fin.hang_p
        if which == "u":
            op = lambda x: op64_both(x, zero_p)[0]
        else:
            op = lambda x: op64_both(zero_u, x)[1]
        op32 = _masked_op(jac32, gather, free, lo, hi, hang)
        M32 = make_vcycle(level_ops, dim=dim, which=which, degree=degree)
        bnorm = jnp.sqrt(jnp.vdot(b, b).real)
        target2 = jnp.maximum(rtol * bnorm, 100.0 * eps64 * bnorm) ** 2

        def one_pass(r0, rr0):
            # the pass runs ENTIRELY in float32 (matvec included);
            # float64 appears only in the exact residual the caller
            # computes between passes.
            # Normalize so the f32 Krylov works near unit scale even on
            # noise-level right-hand sides.
            scale = jnp.sqrt(rr0)
            inv_scale = jnp.where(scale > 0, 1.0 / scale, 0.0)
            r0s = (r0 * inv_scale).astype(jnp.float32)
            tol2 = jnp.asarray(
                jnp.maximum(jnp.maximum(rtol, 1e-5) ** 2,
                            jnp.where(rr0 > 0, target2 / rr0, 1.0)),
                jnp.float32)
            z0 = M32(r0s)

            def cond(s):
                x, r, z, pvec, rz, k, xb, rrb = s
                return (rrb > tol2) & (k < inner_max)

            def body(s):
                x, r, z, pvec, rz, k, xb, rrb = s
                Ap = op32(pvec)
                denom = jnp.vdot(pvec, Ap)
                alpha = jnp.where(denom != 0, rz / denom, 0.0)
                x = x + alpha * pvec
                r = r - alpha * Ap
                rr = jnp.vdot(r, r).real
                better = rr < rrb
                xb = jnp.where(better, x, xb)
                rrb = jnp.where(better, rr, rrb)
                z = M32(r)
                rz_new = jnp.vdot(r, z)
                beta = jnp.where(rz != 0, rz_new / rz, 0.0)
                pvec = z + beta * pvec
                return x, r, z, pvec, rz_new, k + 1, xb, rrb

            s0 = (jnp.zeros_like(r0s), r0s, z0, z0, jnp.vdot(r0s, z0),
                  jnp.asarray(0), jnp.zeros_like(r0s),
                  jnp.asarray(1.0, jnp.float32))
            s = jax.lax.while_loop(cond, body, s0)
            dx = s[6].astype(jnp.float64) * scale
            return dx, s[5]  # best iterate (rescaled), iterations

        def outer_body(carry):
            x_acc, r_cur, rr_cur, its, done = carry
            dx, k = one_pass(r_cur, rr_cur)
            x_try = x_acc + dx
            r_try = b - op(x_try)
            rr_try = jnp.vdot(r_try, r_try).real
            ok = jnp.isfinite(rr_try) & (rr_try < rr_cur)
            x_acc = jnp.where(ok, x_try, x_acc)
            r_cur = jnp.where(ok, r_try, r_cur)
            rr_new = jnp.where(ok, rr_try, rr_cur)
            # done when converged, or stagnated at the arithmetic floor
            # (a pass that couldn't even halve the residual norm);
            # slow-but-real progress (inner_max-bounded) continues
            done = (~ok) | (rr_new <= target2) | (rr_new > 0.25 * rr_cur)
            return x_acc, r_cur, rr_new, its + k, done

        def outer_cond(carry):
            _, _, rr_cur, its, done = carry
            return (~done) & (rr_cur > target2)

        rr_b = jnp.vdot(b, b).real
        carry = (jnp.zeros_like(b), b, rr_b, jnp.asarray(0),
                 jnp.asarray(False))
        # run at least one pass, then up to `passes` total
        carry = outer_body(carry)
        for _ in range(passes - 1):
            carry = jax.lax.cond(outer_cond(carry), outer_body,
                                 lambda c: c, carry)
        x_acc, r_cur, rr_cur, its, _ = carry
        return x_acc, its, rr_cur

    du, it_u, rr_u = block_solve("u", rhs_u)
    rhs_p2 = rhs_p - op64_both(du, zero_p)[1]   # b_p - J_pu du, f64
    dp, it_p, rr_p = block_solve("p", rhs_p2)
    return du, dp, it_u + it_p, rr_u + rr_p, reuse_out


# ---------------------------------------------------------------------------
# the preconditioned solve (block-triangular CG, chunked dispatches)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("dim",))
def _build_ops(levels, P_embed, jac_fine, ca_fine, active, con,
               *, dim: int, reuse=None):
    from .multigrid import sharp_spectrum
    hier = GalerkinHierarchy(levels=levels, P_embed=P_embed, dim=dim)
    return build_level_ops(hier, jac_fine, ca_fine, active, con,
                           dim=dim,
                           sharp=sharp_spectrum(
                               int(active.shape[0]) * (dim + 1)),
                           reuse=reuse)


@partial(jax.jit, static_argnames=("dim", "which", "chunk", "degree",
                                   "f64_op"))
def _cg_chunk(level_ops, jac64, gather64, state, tol2, *, dim: int,
              which: str, chunk: int, degree: int, f64_op: bool):
    """One bounded PCG advance.  The V-cycle preconditioner always runs
    in the level_ops dtype (float32 in production); with f64_op=True the
    CG vectors and the fine matvec run in float64 on jac64 — full f64
    solution accuracy at f32 preconditioner cost.

    The state carries the best-residual iterate seen so far; CG chasing
    a tolerance near its kappa*eps floor can otherwise drift to huge
    iterates, and the caller gets x_best, never the drifted tail."""
    nvc = 2 ** dim
    nud_l = nvc * dim
    lo, hi = (0, nud_l) if which == "u" else (nud_l, nud_l + nvc)
    fin = level_ops[-1]
    gather = fin.gather_u if which == "u" else fin.gather_p
    free = fin.free_u if which == "u" else fin.free_p
    hang = fin.hang_u if which == "u" else fin.hang_p
    if f64_op:
        op = _masked_op(jac64, gather64, free, lo, hi, hang)
    else:
        op = _masked_op(fin.jac, gather, free, lo, hi, hang)
    M32 = make_vcycle(level_ops, dim=dim, which=which, degree=degree)
    vdtype = jac64.dtype if f64_op else fin.jac.dtype
    M = (lambda r: M32(r.astype(fin.jac.dtype)).astype(vdtype)) \
        if f64_op else M32

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
        z = M(r)
        rz_new = jnp.vdot(r, z)
        beta = jnp.where(rz != 0, rz_new / rz, 0.0)
        pvec = z + beta * pvec
        return x, r, z, pvec, rz_new, k + 1, k0, xb, rrb

    x, r, z, pvec, rz, k, xb, rrb = state
    s = jax.lax.while_loop(cond, body, (x, r, z, pvec, rz, k, k, xb, rrb))
    out = s[:6] + (s[7], s[8])
    return out, s[8]


@partial(jax.jit, static_argnames=("dim", "which", "degree"))
def _first_z(level_ops, b, *, dim: int, which: str, degree: int):
    M = make_vcycle(level_ops, dim=dim, which=which, degree=degree)
    z = M(b)
    return z, jnp.vdot(b, z)


def solve_cg_block(hier: GalerkinHierarchy, jac_fine, ca_fine, con,
                   active, rhs_u, rhs_p, rtol, atol, *, dim: int,
                   maxiter: int, chunk: int = 50, degree: int = 2,
                   jac64=None, ca64=None):
    """Galerkin-GMG-preconditioned block-triangular CG on the stored
    element matrices (the AMG+GMRES analogue, cracks.cc:2762-2771).

    jac_fine/ca_fine set the V-cycle dtype (float32 in production).
    With jac64/ca64 given, the CG itself runs in float64 on those
    matrices (mixed-precision-preconditioner mode).

    Returns (du, dp, iters) on the FREE subspace."""
    level_ops, _ = _build_ops(hier.levels, hier.P_embed, jac_fine,
                              ca_fine, active, con, dim=dim)
    f64_op = jac64 is not None
    if not f64_op:
        jac64 = jac_fine
    vdt = jac64.dtype if f64_op else jac_fine.dtype
    eps = float(jnp.finfo(vdt).eps)

    nvc = 2 ** dim
    nud_l = nvc * dim

    def run_block(which, b):
        b = b.astype(vdt)
        gather64 = (ca64.gather_u if which == "u" else ca64.gather_p) \
            if f64_op else (ca_fine.gather_u if which == "u"
                            else ca_fine.gather_p)
        lo, hi = (0, nud_l) if which == "u" else (nud_l, nud_l + nvc)
        fin_free = (level_ops[-1].free_u if which == "u"
                    else level_ops[-1].free_p)
        fin_hang = (level_ops[-1].hang_u if which == "u"
                    else level_ops[-1].hang_p)
        op64 = _masked_op(jac64, gather64, fin_free, lo, hi, fin_hang)
        bnorm = float(jnp.sqrt(jnp.vdot(b, b).real))
        # overall target, floored at ~100 eps relative (below that CG
        # stagnates on rounding noise while the iterate drifts)
        target2 = max(rtol * bnorm, atol, 100.0 * eps * bnorm) ** 2

        # Restarted refinement passes: a float32 preconditioner adds
        # ~1e-7-relative noise per application, which makes a single
        # long CG crawl through its final decades.  Each pass therefore
        # only solves to 1e-6 relative and RESTARTS on the exact f64
        # residual — the restart rescales the noise to the new rhs and
        # the next pass converges at full speed again.
        x_acc = jnp.zeros_like(b)
        r_cur = b
        rr_cur = bnorm * bnorm
        its = 0
        for _ in range(4):
            tol2 = max(np.sqrt(rr_cur) * max(rtol, 1e-6),
                       np.sqrt(target2)) ** 2
            z0, _ = _first_z(level_ops, r_cur.astype(jac_fine.dtype),
                             dim=dim, which=which, degree=degree)
            z0 = z0.astype(vdt)
            state = (jnp.zeros_like(b), r_cur, z0, z0,
                     jnp.vdot(r_cur, z0), jnp.asarray(0),
                     jnp.zeros_like(b), jnp.asarray(rr_cur, vdt))
            rr = rr_cur
            stalled = False
            stalls = 0
            while rr > tol2 and int(state[5]) < maxiter - its:
                prev_rr = rr
                state, rr_dev = _cg_chunk(level_ops, jac64, gather64,
                                          state, tol2, dim=dim,
                                          which=which, chunk=chunk,
                                          degree=degree, f64_op=f64_op)
                rr = float(rr_dev)
                if not np.isfinite(rr):
                    stalled = True  # blew up: keep best iterate, stop
                    break
                # a single non-halving chunk can be a mid-convergence
                # plateau of the ill-conditioned fracture operator;
                # require two consecutive ones before calling it a stall
                stalls = stalls + 1 if rr > 0.5 * prev_rr else 0
                if stalls >= 2:
                    stalled = True  # keep the best iterate, stop pass
                    break
            its += int(state[5])
            x_try = x_acc + state[6]
            r_try = b - op64(x_try)
            rr_try = float(jnp.vdot(r_try, r_try).real)
            if not np.isfinite(rr_try) or rr_try >= rr_cur:
                break  # no progress: keep the previous accumulate
            progress = rr_try / max(rr_cur, 1e-300)
            x_acc, r_cur, rr_cur = x_try, r_try, rr_try
            if rr_cur <= target2 or its >= maxiter:
                break
            if stalled and progress > 1e-4:
                break  # at the arithmetic floor — restarts won't help
        return x_acc, its

    du, it_u = run_block("u", rhs_u)
    cjac = jac64 if f64_op else jac_fine
    cca = ca64 if f64_op else ca_fine
    rhs_p2 = assembled._coupling_rhs(cjac, cca, con, active,
                                     du.astype(cjac.dtype),
                                     rhs_p.astype(cjac.dtype), dim=dim)
    dp, it_p = run_block("p", rhs_p2)
    return du, dp, it_u + it_p


# ---------------------------------------------------------------------------
# split-dispatch solve (large adaptive problems)
# ---------------------------------------------------------------------------
# solve_newton_system fuses the whole mixed-precision solve into ONE
# XLA execution — ideal dispatch-latency-wise at golden sizes.  Above
# lattice.FUSED_SOLVE_MAX_DOFS the functions below run the SAME
# algorithm (all-f32 Galerkin-GMG CG passes + exact f64 matrix-free
# refinement between passes) as host-orchestrated device executions,
# mirroring lattice._solve_split.  This is what serves hanging-node
# (adaptive)
# meshes at the sizes where the reference leans on ML-AMG
# (cracks.cc:2477-2497).


@partial(jax.jit, static_argnames=("dim", "with_split", "monolithic"))
def _g_jac32(u, phi, phi_old, phi_oold, ca64, sc, *, dim, with_split,
             monolithic):
    """f32 stored element Jacobians at the Newton point (one bounded
    dispatch; f64 matrices are never built — the refinement operator is
    matrix-free, see _g_pass_apply)."""
    f32c = lambda x: x.astype(jnp.float32)
    ca32 = physics.CellArrays(
        gather_u=ca64.gather_u, gather_p=ca64.gather_p,
        JxW=f32c(ca64.JxW), grads=f32c(ca64.grads),
        shape_v=f32c(ca64.shape_v), lam=f32c(ca64.lam),
        mu=f32c(ca64.mu), inv_diam2=f32c(ca64.inv_diam2),
        chunked=None)
    return physics.element_matrices(
        f32c(u), f32c(phi), f32c(phi_old), f32c(phi_oold), ca32,
        physics.Scalars(*(f32c(v) for v in sc)),
        dim=dim, with_split=with_split, monolithic=monolithic,
        cell_last=True)


@partial(jax.jit, static_argnames=("dim", "which"))
def _g_pass_setup(level_ops, r, rtol, target2, *, dim, which):
    """f64 -> f32 boundary of one CG pass (flat dof vectors)."""
    fin = level_ops[-1]
    free = fin.free_u if which == "u" else fin.free_p
    rr0 = jnp.vdot(r, r).real
    scale = jnp.sqrt(rr0)
    inv_scale = jnp.where(scale > 0, 1.0 / scale, 0.0)
    R0 = jnp.where(free, (r * inv_scale).astype(jnp.float32), 0.0)
    tol2 = jnp.asarray(
        jnp.maximum(jnp.maximum(rtol, 3e-7) ** 2,
                    jnp.where(rr0 > 0, target2 / rr0, 1.0)), jnp.float32)
    return R0, scale, tol2, rr0


@partial(jax.jit, static_argnames=("dim", "which", "degree",
                                   "inner_max", "stall_window"))
def _g_cg_pass32(level_ops, R0, tol2, *, dim, which, degree=2,
                 inner_max=192, stall_window=16):
    """One all-f32 Galerkin-GMG CG pass on the normalized residual;
    returns (best iterate, iterations, best rr).  Stall guard exits
    when no new best residual appears within `stall_window` iterations
    (the f32 arithmetic floor)."""
    nvc = 2 ** dim
    nud_l = nvc * dim
    lo, hi = (0, nud_l) if which == "u" else (nud_l, nud_l + nvc)
    fin = level_ops[-1]
    gather = fin.gather_u if which == "u" else fin.gather_p
    free = fin.free_u if which == "u" else fin.free_p
    hang = fin.hang_u if which == "u" else fin.hang_p
    op32 = _masked_op(fin.jac, gather, free, lo, hi, hang)
    M32 = make_vcycle(level_ops, dim=dim, which=which, degree=degree)
    Z0 = M32(R0)

    def cond(s):
        X, R, Z, Pv, rz, kk, Xb, rrb, kb = s
        return (rrb > tol2) & (kk < inner_max) & (kk - kb < stall_window)

    def body(s):
        X, R, Z, Pv, rz, kk, Xb, rrb, kb = s
        Ap = op32(Pv)
        denom = jnp.vdot(Pv, Ap)
        alpha = jnp.where(denom != 0, rz / denom, 0.0)
        X = X + alpha * Pv
        R = R - alpha * Ap
        rr = jnp.vdot(R, R).real
        better = rr < rrb
        Xb = jnp.where(better, X, Xb)
        rrb = jnp.where(better, rr, rrb)
        kb = jnp.where(better, kk + 1, kb)
        Z = M32(R)
        rz_new = jnp.vdot(R, Z)
        beta = jnp.where(rz != 0, rz_new / rz, 0.0)
        Pv = Z + beta * Pv
        return X, R, Z, Pv, rz_new, kk + 1, Xb, rrb, kb

    s0 = (jnp.zeros_like(R0), R0, Z0, Z0, jnp.vdot(R0, Z0),
          jnp.asarray(0, jnp.int32), jnp.zeros_like(R0),
          jnp.asarray(1.0, jnp.float32), jnp.asarray(0, jnp.int32))
    s = jax.lax.while_loop(cond, body, s0)
    return s[6], s[5], s[7]


@partial(jax.jit, static_argnames=("dim", "which", "with_split",
                                   "monolithic"))
def _g_pass_apply(u, phi, phi_old, phi_oold, ca64, sc, con, active,
                  Xb, scale, x_acc, b, *, dim, which, with_split,
                  monolithic):
    """f32 -> f64 boundary of one CG pass, fused into one dispatch:
    un-normalize the pass iterate, apply the EXACT f64 Newton operator
    MATRIX-FREE (one linearized jvp at the Newton point — f64 element
    matrices are never built, see solve_newton_system's rationale) and
    compute the trial residual.  Returns (x_try, r_try, rr_try, jp)
    with jp = J_pu x_try for which == 'u'."""
    from ..ops.constraints import condense_residual, expand_update

    x_try = x_acc + Xb.astype(jnp.float64) * scale

    def res64(uu, pp):
        return physics.assemble_residual(
            uu, pp, phi_old, phi_oold, ca64, sc,
            dim=dim, with_split=with_split, monolithic=monolithic)

    zero_u = jnp.zeros(con.dirichlet_u.shape[0], jnp.float64)
    zero_p = jnp.zeros(con.dirichlet_p.shape[0], jnp.float64)
    xu = x_try if which == "u" else zero_u
    xp = zero_p if which == "u" else x_try
    eu, ep = expand_update(xu, xp, con, active)
    _, (ju, jp_raw) = jax.jvp(res64, (u, phi), (eu, ep))
    ju, jp = condense_residual(-ju, -jp_raw, con, active)
    y = ju if which == "u" else jp
    r_try = b - y
    rr_try = jnp.vdot(r_try, r_try).real
    jp_out = jp if which == "u" else zero_p
    return x_try, r_try, rr_try, jp_out


def solve_split(sys, hier: GalerkinHierarchy, u, phi, phi_old, phi_oold,
                con, active, rhs_u, rhs_p, with_split, passes=16):
    """Host-orchestrated restarted-refinement solve on adaptive
    (hanging-node) meshes with bounded device executions.
    Mathematically identical to solve_newton_system.  Returns
    (du, dp, total_its) on the free subspace."""
    import os

    p = sys.params
    rtol = p.cg_rtol
    eps64 = float(np.finfo(np.float64).eps)
    kw = dict(dim=sys.dim, with_split=with_split,
              monolithic=sys.monolithic)
    debug = os.environ.get("CRACKS_TPU_DEBUG_SOLVE") == "1"
    import time as _wt
    _tsplit = _wt.perf_counter()

    def _mark(label):
        if debug:
            print(f"#     [@{label}: "
                  f"{_wt.perf_counter() - _tsplit:6.2f}s]", flush=True)

    # f32 operator reuse across PDAS tail iterations (same staleness
    # contract as lattice._solve_split: inexact-Newton delta <= 1e-6)
    from .lattice import _iter_dist, _scalars_vec
    cache = getattr(sys, "_split_jac_cache_g", None)
    sc_vec = _scalars_vec(sys.scalars)
    jac32 = None
    if cache is not None:
        key0, flags0, jac32_c = cache
        if (flags0 == (with_split, sys.monolithic)
            and all(a.shape == b.shape for a, b in
                    zip(key0, (u, phi, phi_old, phi_oold, sc_vec)))):
            d = float(_iter_dist(u, phi, phi_old, phi_oold, sc_vec,
                                 *key0))
            if d <= float(os.environ.get("CRACKS_TPU_JAC_RTOL",
                                         "1e-6")):
                jac32 = jac32_c
            if debug:
                print(f"#     [jac-g "
                      f"{'reuse' if jac32 is not None else 'rebuild'}:"
                      f" context moved {d:.1e}]", flush=True)
        del jac32_c
    if jac32 is None:
        # drop the stale operator AND its level cache before building
        # replacements (avoid double-buffering the RAP chain)
        sys._split_jac_cache_g = None
        sys._split_levels_cache_g = None
        jac32 = _g_jac32(u, phi, phi_old, phi_oold, sys.ca,
                         sys.scalars, **kw)
        sys._split_jac_cache_g = ((u, phi, phi_old, phi_oold, sc_vec),
                                  (with_split, sys.monolithic), jac32)
    _mark("jac32-ready")
    # u-block level cache: the RAP chain + u-side masks/diagonals/
    # Lanczos spectra depend only on jac32 (NOT the active set), so
    # they ride the jac reuse across the PDAS tail; only the p-block
    # data (active-set mask in free_p) is rebuilt per iteration.
    lv_cache = getattr(sys, "_split_levels_cache_g", None)
    reuse = (lv_cache[1] if lv_cache is not None
             and lv_cache[0] is jac32
             and os.environ.get("CRACKS_TPU_REUSE") != "0" else None)
    level_ops, reuse_out = _build_ops(hier.levels, hier.P_embed, jac32,
                                      sys.ca, active, con, dim=sys.dim,
                                      reuse=reuse)
    sys._split_levels_cache_g = (jac32, reuse_out)
    _mark("level-ops-ready")
    total_its = 0
    last_jp = [None]

    def block(which, b):
        nonlocal total_its
        _mark(f"enter-{which}")
        bnorm = float(jnp.sqrt(jnp.vdot(b, b).real))
        _mark(f"bnorm-{which}")
        atol_newton = 1e-3 * p.lower_bound_newton_residual
        target2 = max(rtol * bnorm, atol_newton,
                      100.0 * eps64 * bnorm) ** 2
        if bnorm * bnorm <= target2:
            return jnp.zeros_like(b)
        target2_d = jnp.asarray(target2)
        x_acc = jnp.zeros_like(b)
        r_cur = b
        rr_cur = bnorm * bnorm
        setup = None
        for _ in range(passes):
            if rr_cur <= target2:
                break
            _t0 = _wt.perf_counter() if debug else 0.0
            if setup is None:
                setup = _g_pass_setup(level_ops, r_cur, rtol, target2_d,
                                      dim=sys.dim, which=which)
            R0, scale_d, tol2, _rr0 = setup
            if debug:
                jax.block_until_ready(R0)
                _t1 = _wt.perf_counter()
            else:
                _t1 = 0.0
            # 32-iteration passes: restarts only cost the Krylov
            # memory, which the f64 refinement pass structure absorbs.
            # The cap changes numerics.
            inner_max = int(os.environ.get("CRACKS_TPU_G_INNER", "32"))
            degree = int(os.environ.get("CRACKS_TPU_CHEB_DEGREE", "2"))
            Xb, k_d, _rrb = _g_cg_pass32(level_ops, R0, tol2,
                                         dim=sys.dim, which=which,
                                         inner_max=inner_max,
                                         degree=degree)
            if debug:
                jax.block_until_ready(Xb)
                _t2 = _wt.perf_counter()
            else:
                _t2 = 0.0
            x_try, r_try, rr_try_d, jp_d = _g_pass_apply(
                u, phi, phi_old, phi_oold, sys.ca, sys.scalars, con,
                active, Xb, scale_d, x_acc, b, dim=sys.dim,
                which=which, **{k: v for k, v in kw.items()
                                if k != "dim"})
            k_h, rr_try = jax.device_get((k_d, rr_try_d))
            total_its += int(k_h)
            rr_try = float(rr_try)
            if debug:
                _t3 = _wt.perf_counter()
                print(f"#   {which}-pass(g): its={int(k_h)} "
                      f"rrb32={float(_rrb):.3e} "
                      f"rr {rr_cur:.6e} -> {rr_try:.6e} "
                      f"(target {target2:.3e}) "
                      f"[setup {_t1 - _t0:.2f}s cg {_t2 - _t1:.2f}s "
                      f"apply {_t3 - _t2:.2f}s]", flush=True)
            if not np.isfinite(rr_try) or rr_try >= rr_cur:
                break
            progress = rr_try / max(rr_cur, 1e-300)
            x_acc, r_cur = x_try, r_try
            if which == "u":
                last_jp[0] = jp_d
            rr_cur = rr_try
            setup = None
            # progress > 0.25 on a pass that did NOT exhaust its
            # iteration cap means genuine stagnation (the f32 floor);
            # a capped pass simply needs more passes — the cap only
            # bounds the single-dispatch execution time.
            if rr_cur <= target2 or (progress > 0.25
                                     and int(k_h) < inner_max):
                break
        return x_acc

    du = block("u", rhs_u)
    _mark("u-done")
    rhs_p2 = rhs_p if last_jp[0] is None else rhs_p - last_jp[0]
    dp = block("p", rhs_p2)
    _mark("p-done")
    return du, dp, total_its
