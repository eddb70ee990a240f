"""Tensor-grid (monolattice) fast path for the Newton-system solve.

The generic stored-matrix Krylov operator (solvers/assembled.py) does a
dynamic gather + batched einsum + scatter per application.  On a
uniformly refined tensor-product mesh (the production Sneddon /
bench configurations: ``rect_mesh`` / ``unit cube`` roots,
``n_global_pre_refine`` refinements, no hanging nodes) the mesh IS a
global lattice — (GY, GX) in 2d, (GZ, GY, GX) in 3d — and every FEM
gather/scatter is a SHIFTED ARRAY SLICE:

  * cell->vertex gather   = 2^dim shifted cell-grid windows of the
    vertex lattice;
  * vertex scatter-add    = 2^dim shifted window adds;
  * 2:1 restriction/prolongation = strided slices ([::2]), applied
    separably per axis (the tensor-product Q1 transfer factorizes);
  * Galerkin element-RAP coarsening = [o::2, ...] slices + einsum with
    the constant embedding matrices;
  * the active-set injection to level l = [::2**l, ...].

No dynamic gather appears anywhere in the Krylov loop; everything
streams.  This is the JAX analogue of the reference's assembled-matrix
solve path (cracks.cc:2744-2777) — with runtime-dim dispatch like the
reference's (cracks.cc:4648-4658) — specialized to the structured
meshes where production cycles are spent.

Lattice state layout: vectors are (comp, *grid) with comp tiny and
LEADING, so the grid axes are the contiguous minor dimensions.  Element
data is (..., *cellgrid).

Every f32 contraction here runs at Precision.HIGHEST: a GPU may
otherwise evaluate float32 products in TF32 (~3 decimal digits).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import physics
from .galerkin import embedding_matrices


@lru_cache(maxsize=None)
def _offsets(dim: int) -> tuple:
    """Corner a -> per-grid-axis offsets, grid axes ordered slowest to
    fastest (z, y, x).  Matches fem.py's lexicographic Q1 vertex order:
    local vertex a has reference coordinate along geometric axis d equal
    to (a >> d) & 1 (fem.py:99-102), and grid axis j is geometric axis
    dim-1-j."""
    return tuple(
        tuple(((a >> (dim - 1 - j)) & 1) for j in range(dim))
        for a in range(2 ** dim))


def _win(o, G):
    """Index tuple selecting the shifted cell-grid window at corner
    offset o of a (*, *G) vertex-lattice array."""
    return (slice(None),) + tuple(
        slice(o[j], G[j] - 1 + o[j]) for j in range(len(G)))


class Seam(NamedTuple):
    """Static description of a horizontal slit cut into the vertex
    lattice (the reference's `unit_slit.inp` family, cracks.cc:1202-1205:
    a slit from the domain interior to the +x boundary whose lip
    vertices are DUPLICATED — two DoFs per geometric point so the crack
    faces displace independently).

    The lattice embeds the cut domain by duplicating the entire slit
    row: vertex row `s` carries the lower-lip copies, row `s+1` the
    upper-lip copies, and at the GLUED columns [0, slit_lo) — where the
    material is continuous — both rows represent the SAME DoF.  The
    cell raster gains one dead row (index `s`, zero element matrices)
    between the lips, which keeps the cell->vertex gather a pure
    shifted-window slice on both sides of the cut.

    DoF vectors are kept in CANONICAL form — the shared value lives in
    row `s`, the mirror entries (row s+1, glued columns) are zero — so
    lattice dot products count each DoF once.  Every stencil operator
    application is conjugated as  collect . stencil . spread  (exactly
    S^T A S for the duplication map S), which is the structured-grid
    form of the reference's hanging-node-style constraint handling.

    All fields are python ints, so a Seam is a hashable jit-static."""

    s: int        # lower-lip vertex row (grid axis 0); mirror row = s+1
    slit_lo: int  # first duplicated column; slit = [slit_lo, GX) to the
    #               +x boundary, glued columns = [0, slit_lo)


def seam_spread(X, seam: Seam | None):
    """Canonical -> consistent: copy the shared values into the mirror
    row so the stencil sees the function on both sides of the seam.

    Expressed as a one-hot row matmul + masked select rather than a
    cross-row slice update: arithmetically identical (each output
    element is a plain copy), but GSPMD partitions it correctly on a
    row-slab-sharded lattice — the chained `.at[:, s+1, :lo].set(...)`
    form miscompiled at slab boundaries when composed with the window
    scatter under the XLA CPU partitioner (wrong rows far from the
    seam, observed 2026-08-19)."""
    if seam is None:
        return X
    s, lo = seam.s, seam.slit_lo
    gy, gx = X.shape[1], X.shape[2]
    E = np.eye(gy)
    E[s + 1] = 0.0
    E[s + 1, s] = 1.0
    M = np.zeros((gy, gx), bool)
    M[s + 1, :lo] = True
    Xs = jnp.einsum("rq,kqc->krc", jnp.asarray(E, X.dtype), X,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.where(jnp.asarray(M), Xs, X)


def seam_collect(Y, seam: Seam | None):
    """Consistent -> canonical: sum the mirror-row contributions into
    the shared row and zero the mirror (the S^T of seam_spread).
    Matmul + masked-select formulation for GSPMD partition-safety (see
    seam_spread); each output element is a copy, a zero, or the same
    two-term sum as the slice-update form."""
    if seam is None:
        return Y
    s, lo = seam.s, seam.slit_lo
    gy, gx = Y.shape[1], Y.shape[2]
    A = np.eye(gy)
    A[s, s + 1] = 1.0
    Ms = np.zeros((gy, gx), bool)
    Ms[s, :lo] = True
    Ms1 = np.zeros((gy, gx), bool)
    Ms1[s + 1, :lo] = True
    Ys = jnp.einsum("rq,kqc->krc", jnp.asarray(A, Y.dtype), Y,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.where(jnp.asarray(Ms1), jnp.zeros((), Y.dtype),
                     jnp.where(jnp.asarray(Ms), Ys, Y))


def seam_coarse(seam: Seam | None) -> Seam | None:
    """Seam of the 2:1-coarsened lattice.  Requires s even (the slit
    line lies on the coarse grid) and slit_lo odd (the first duplicated
    column coarsens cleanly: ceil keeps every glued fine midpoint
    interpolated from two glued coarse nodes, which is what makes the
    per-slab element-RAP EXACTLY the Galerkin coarse operator)."""
    if seam is None:
        return None
    assert seam.s % 2 == 0 and seam.slit_lo % 2 == 1
    return Seam(s=seam.s // 2, slit_lo=(seam.slit_lo + 1) // 2)


def _seam_can_coarsen(grid, seam: Seam | None) -> bool:
    if seam is None:
        return all((g - 1) % 2 == 0 for g in grid)
    gy, gx = grid
    return ((gy - 2) % 2 == 0 and (gx - 1) % 2 == 0
            and seam.s % 2 == 0 and seam.s >= 2
            and seam.slit_lo % 2 == 1)


def _seam_coarse_grid(grid, seam: Seam | None) -> tuple:
    if seam is None:
        return tuple((g - 1) // 2 + 1 for g in grid)
    return ((grid[0] - 2) // 2 + 2, (grid[1] - 1) // 2 + 1)


def _seam_inject_down(A, seam: Seam | None):
    """One-level injection of a (k, *grid) lattice field to the coarse
    lattice (the [::2] of the seam-free path, slab-aware: the mirror row
    s+1 starts the upper slab so both lips inject to their coarse lips)."""
    if seam is None:
        return A[(slice(None),) + tuple(slice(None, None, 2)
                                        for _ in A.shape[1:])]
    s = seam.s
    below = A[:, 0:s + 1:2]
    above = A[:, s + 1::2]
    cat = (np.concatenate if isinstance(A, np.ndarray)
           else jnp.concatenate)
    return cat([below, above], axis=1)[:, :, ::2]


def seam_levels(seam: Seam | None, n_levels: int) -> tuple:
    """Per-level seams, coarsest..finest (the seam_coarse chain)."""
    out = [seam]
    for _ in range(n_levels - 1):
        out.insert(0, seam_coarse(out[0]))
    return tuple(out)


class LatticeLayout(NamedTuple):
    """Host-built tensor-grid identification of a MeshData."""

    grid: tuple             # vertex extents, slowest..fastest (y,x)/(z,y,x)
    vert_idx: np.ndarray    # (*grid) int32 global vertex id per node
    vert_pos: np.ndarray    # (n_v,) int32 flat lattice pos per vertex
    cell_perm: np.ndarray   # (n_cells,) raster -> mesh cell id; -1 =
    #                         dead (seam-padding) raster slots
    seam: Seam | None = None


def detect_tensor_grid(mesh) -> LatticeLayout | None:
    """Identify a mesh whose vertices form an exact tensor grid (2d or
    3d), or — in 2d — a tensor grid cut by one horizontal slit whose lip
    vertices are duplicated (the reference's `unit_slit.inp` family,
    cracks.cc:1202-1205).  Slit meshes come back with a `Seam` and a
    cell raster padded by one dead row; anything else (hanging nodes,
    unstructured meshes like threepoint.msh) returns None."""
    if mesh.dim not in (2, 3) or len(mesh.hang_child):
        return None
    dim = mesh.dim

    def axis_index(vals):
        """Cluster coordinates that differ only by multilinear-map float
        noise across roots (observed ~1e-16 relative); returns (index
        per value, n_clusters)."""
        s = np.sort(np.unique(vals))
        span = s[-1] - s[0]
        if span <= 0:
            return None
        tol = 1e-9 * span
        brk = np.diff(s) > tol
        cid = np.r_[0, np.cumsum(brk)]
        # reject if clusters are not well separated vs the tolerance
        if len(s) > 1 and np.diff(s)[brk].min(initial=np.inf) < 100 * tol:
            return None
        idx = cid[np.searchsorted(s, vals)]
        return idx, cid[-1] + 1

    # geometric axes x,y(,z); grid axes are reversed (z,y,x)
    res = [axis_index(mesh.vert_coords[:, d]) for d in range(dim)]
    if any(r is None for r in res):
        return None
    gidx = [r[0] for r in res][::-1]          # per grid axis
    grid = tuple(int(r[1]) for r in res)[::-1]
    if min(grid) < 4:
        return None
    nv = mesh.n_vertices
    pos = np.zeros(nv, np.int64)
    for j in range(dim):
        pos = pos * grid[j] + gidx[j]
    if int(np.prod(grid)) != nv or len(np.unique(pos)) != nv:
        if dim == 2 and int(np.prod(grid)) < nv:
            return _detect_slit_grid(mesh, grid, gidx, pos)
        return None
    vert_idx = np.full(int(np.prod(grid)), -1, np.int64)
    vert_idx[pos] = np.arange(nv)
    if (vert_idx < 0).any():
        return None
    vert_idx = vert_idx.reshape(grid)

    # cells: locate each cell by its first (lexicographically lowest)
    # vertex; require the full cell raster and the fem.py corner order
    cgrid = tuple(g - 1 for g in grid)
    if mesh.n_cells != int(np.prod(cgrid)):
        return None
    ll = mesh.cell2vert[:, 0]
    cpos = np.array(np.unravel_index(pos[ll], grid))   # (dim, n_c)
    offs = _offsets(dim)
    expect = np.stack([
        vert_idx[tuple(cpos[j] + o[j] for j in range(dim))]
        for o in offs], axis=1)
    if not (expect == mesh.cell2vert).all():
        return None
    craster = np.zeros(mesh.n_cells, np.int64)
    for j in range(dim):
        craster = craster * cgrid[j] + cpos[j]
    raster = np.full(int(np.prod(cgrid)), -1, np.int64)
    raster[craster] = np.arange(mesh.n_cells)
    if (raster < 0).any():
        return None
    return LatticeLayout(grid=grid,
                         vert_idx=vert_idx.astype(np.int32),
                         vert_pos=pos.astype(np.int32),
                         cell_perm=raster.astype(np.int32))


def _detect_slit_grid(mesh, grid0, gidx, pos0) -> LatticeLayout | None:
    """Seam branch of detect_tensor_grid: the vertex coordinates form a
    (gy0, gx0) product grid but some positions carry TWO vertices — the
    duplicated lips of a horizontal slit.  Accepts exactly the reference
    slit-mesh pattern (one slit row, duplicated columns contiguous to
    the +x boundary) and embeds it as a (gy0+1, gx0) lattice with a
    `Seam` (see Seam).  Every structural assumption is verified; any
    mismatch returns None and the caller falls back to the gather-based
    Galerkin path."""
    gy0, gx0 = grid0
    nv = mesh.n_vertices
    ri, ci = gidx                                      # row, col per vertex
    uniq, counts = np.unique(pos0, return_counts=True)
    if counts.max() != 2 or len(uniq) != gy0 * gx0:
        return None
    dup = uniq[counts == 2]
    rows = dup // gx0
    if len(np.unique(rows)) != 1:
        return None
    s0 = int(rows[0])
    if not (1 <= s0 <= gy0 - 2):
        return None
    cols = np.sort(dup % gx0)
    lo = int(cols[0])
    # contiguous duplicated columns reaching the +x boundary
    if lo < 1 or not (cols == np.arange(lo, gx0)).all():
        return None

    # classify each lip copy by its cell corner role: fem.py corner
    # order has corners 0,1 at local y-offset 0 (cell bottoms) and 2,3
    # at y-offset 1 (cell tops).  A lip vertex referenced only as a TOP
    # corner belongs to cells below the slit = the LOWER lip.
    c2v = mesh.cell2vert
    top = np.zeros(nv, bool)
    bot = np.zeros(nv, bool)
    bot[c2v[:, 0]] = True
    bot[c2v[:, 1]] = True
    top[c2v[:, 2]] = True
    top[c2v[:, 3]] = True
    is_dup = np.isin(pos0, dup)
    lower = is_dup & top & ~bot
    upper = is_dup & bot & ~top
    if not ((lower | upper) == is_dup).all():
        return None
    if not (np.sum(lower) == np.sum(upper) == gx0 - lo):
        return None

    # expanded lattice: +1 row; lower lip + glued stay on row s0,
    # upper lip moves to the new row s0+1, rows beyond shift up
    gy = gy0 + 1
    grid = (gy, gx0)
    row_new = ri.astype(np.int64)
    row_new = np.where(ri > s0, row_new + 1, row_new)
    row_new = np.where(upper, s0 + 1, row_new)
    pos = row_new * gx0 + ci
    if len(np.unique(pos)) != nv:
        return None
    vert_idx = np.full(gy * gx0, -1, np.int64)
    vert_idx[pos] = np.arange(nv)
    vert_idx = vert_idx.reshape(grid)
    # consistent view: mirror slots (row s0+1, glued cols) alias the
    # shared vertex — used to verify cell connectivity below
    vic = vert_idx.copy()
    vic[s0 + 1, :lo] = vic[s0, :lo]
    if (vic < 0).any():
        return None

    # cells: row from the top-left corner (strictly above the slit for
    # above-slit cells, so the dead raster row s0 stays empty), col from
    # the bottom-left corner
    r_c = row_new[c2v[:, 2]] - 1
    c_c = ci[c2v[:, 0]].astype(np.int64)
    cgrid = (gy - 1, gx0 - 1)
    if (r_c < 0).any() or (r_c >= cgrid[0]).any() or \
            (c_c < 0).any() or (c_c >= cgrid[1]).any():
        return None
    offs = _offsets(2)
    expect = np.stack([vic[r_c + o[0], c_c + o[1]] for o in offs],
                      axis=1)
    if not (expect == c2v).all():
        return None
    craster = r_c * cgrid[1] + c_c
    raster = np.full(int(np.prod(cgrid)), -1, np.int64)
    raster[craster] = np.arange(mesh.n_cells)
    dead = raster.reshape(cgrid) < 0
    if not (dead == (np.arange(cgrid[0])[:, None] == s0)).all():
        return None
    return LatticeLayout(grid=grid,
                         vert_idx=vert_idx.astype(np.int32),
                         vert_pos=pos.astype(np.int32),
                         cell_perm=raster.astype(np.int32),
                         seam=Seam(s=s0, slit_lo=lo))


def permuted_cell_arrays(mesh, lam, mu, lay: LatticeLayout,
                         dtype=jnp.float32,
                         chunk: bool = True,
                         host=None) -> physics.CellArrays:
    """CellArrays with cells in lattice raster order, so the element
    matrices come out of physics.element_matrices already reshapable to
    (ndl, ndl, *cellgrid).  chunk=False skips the scan duplicate (used
    when the cell axis will be sharded across devices instead).

    The permutation happens entirely on HOST numpy (no device arrays
    are built only to be pulled back).  Pass `host` (a
    build_cell_arrays_host result for the same mesh/material) to reuse
    the geometry tables — three consumers need them (f64 ca, lattice
    f32, lattice f64)."""
    (g_u, g_p, JxW, grads, shape_v, lam_, mu_,
     invd2) = (host if host is not None
               else physics.build_cell_arrays_host(mesh, lam, mu))
    p = lay.cell_perm

    def take(a):
        # permute in cell-FIRST layout (contiguous row gather — the
        # host arrays are transpose views of cell-first originals),
        # then one transposing copy back to cell-last; ~5x faster than
        # a fancy gather on the last axis of the big strided views.
        # Negative perm entries (dead seam-padding slots) clamp to
        # cell 0; their JxW is zeroed below, matching
        # physics._derive_cell_arrays.
        af = np.moveaxis(a, -1, 0)[np.maximum(p, 0)]
        return np.ascontiguousarray(np.moveaxis(af, 0, -1))
    g_u, g_p = take(g_u), take(g_p)
    JxW, grads = take(JxW), take(grads)
    lam_, mu_, invd2 = take(lam_), take(mu_), take(invd2)
    if (p < 0).any():
        JxW[..., p < 0] = 0.0
    chunked = None
    if chunk:
        chunked = physics.make_chunked(g_u, g_p, JxW, grads, lam_, mu_,
                                       invd2, dtype)
    j = lambda a, dt=dtype: jnp.asarray(a, dtype=dt)
    return physics.CellArrays(
        gather_u=j(g_u, jnp.int32), gather_p=j(g_p, jnp.int32),
        JxW=j(JxW), grads=j(grads), shape_v=j(shape_v),
        lam=j(lam_), mu=j(mu_), inv_diam2=j(invd2), chunked=chunked)


# ---------------------------------------------------------------------------
# lattice primitives (device; all shapes static)
# ---------------------------------------------------------------------------

def gather_windows(X):
    """(k, *G) vertex lattice -> per-corner cell windows
    (nvc, k, *cellgrid)."""
    G = X.shape[1:]
    offs = _offsets(len(G))
    return jnp.stack([X[_win(o, G)] for o in offs], axis=0)


def scatter_windows(Ye, grid):
    """(nvc, k, *cellgrid) per-corner cell values -> vertex lattice
    (k, *grid) by shifted window adds."""
    k = Ye.shape[1]
    offs = _offsets(len(grid))
    Y = jnp.zeros((k,) + tuple(grid), Ye.dtype)
    for a, o in enumerate(offs):
        Y = Y.at[_win(o, grid)].add(Ye[a])
    return Y


def matvec_block(jacL, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out):
    """Rectangular lattice block matvec: rows [lo_r, hi_r), columns
    [lo_c, hi_c) of the local element matrices.

    jacL: (ndl, ndl, *cellgrid); X: (k_in, *grid) -> (k_out, *grid).
    Local dof order inside a block range: corner-major, k comps per
    corner."""
    G = X.shape[1:]
    Xe = gather_windows(X)                        # (nvc, k_in, *cg)
    nvc = Xe.shape[0]
    Xf = Xe.reshape((nvc * k_in,) + Xe.shape[2:])
    J = jacL[lo_r:hi_r, lo_c:hi_c]
    Yf = jnp.einsum("ij...,j...->i...", J, Xf,
                    precision=jax.lax.Precision.HIGHEST)
    return scatter_windows(Yf.reshape((nvc, k_out) + Yf.shape[1:]), G)


def matvec(jacL, X, lo, hi, k):
    """Masked-free lattice matvec for one (square) block."""
    return matvec_block(jacL, X, lo, hi, lo, hi, k, k)


def block_diag(jacL, lo, hi, k, grid):
    """Lattice diagonal of one block: (k, *grid)."""
    idx = jnp.arange(lo, hi)
    d = jacL[idx, idx]                            # (b, *cg)
    nvc = (hi - lo) // k
    return scatter_windows(d.reshape((nvc, k) + d.shape[1:]), grid)


def gershgorin(jacL, free, Dinv, lo, hi, k, grid, seam: Seam | None = None):
    """Upper bound on lambda_max(D^-1 A) via element-wise over-counted
    Gershgorin row sums (same bound as galerkin._gershgorin_lambda_max).
    With a seam the glued rows' sums add — the row sum of S^T|A|S, still
    an upper bound on the conjugated operator's row sums."""
    rs = jnp.sum(jnp.abs(jacL[lo:hi, lo:hi]), axis=1)  # (b, *cg)
    nvc = (hi - lo) // k
    s = scatter_windows(rs.reshape((nvc, k) + rs.shape[1:]), grid)
    s = seam_collect(s, seam)
    return jnp.max(jnp.where(free, s * jnp.abs(Dinv), 0.0))


def lanczos_lambda(jacL, free, Dinv, lo, hi, k, grid, m: int = 10,
                   seam: Seam | None = None):
    """Sharp lambda_max(D^-1 A) estimate on the free subspace: m-step
    Lanczos on the symmetrized operator S = D^(-1/2) A D^(-1/2), top
    Ritz value readout.

    The element-overcounted Gershgorin bound above overestimates the
    true lambda_max of the Jacobi-scaled FEM blocks by ~1.5-2.3x
    (measured refine 3: u block 5.0 vs exact 2.17, p block 1.95 vs
    1.48), which stretches the Chebyshev smoothing window
    [lam/20, 1.2 lam] past the spectrum and wastes most of the
    polynomial's damping on modes that do not exist.  Plain power
    iteration is NOT enough: the p block is mass-dominated with a
    clustered top spectrum, and 12 power steps sit at 0.44x the true
    lambda_max — a Chebyshev window that far below the spectrum top
    AMPLIFIES the excluded modes and diverges the V-cycle (measured:
    5x the Newton iterations).  Lanczos reaches the same clustered
    extreme in ~10 steps (measured <=1.5% low on every level/block);
    make_vcycle's 1.2 factor covers the residual gap.  This is the
    estimate-then-smooth structure of the reference's ML Chebyshev
    setup (per-level eigen-analysis, cracks.cc:2477-2497), and of
    deal.II's own PreconditionChebyshev (CG-based Lanczos estimate).
    Loss of orthogonality in f32 only duplicates converged Ritz values,
    which is harmless for a max readout.  Cost: m masked lattice
    matvecs per level per Newton solve, amortized over the CG passes."""
    dtype = Dinv.dtype
    sq = jnp.sqrt(jnp.abs(Dinv))
    # Lanczos needs a symmetric operator; with the spectral split in
    # the matrix the u block is NONSYMMETRIC (the linearized Miehe
    # split dsigma+ is not self-adjoint, ops/spectral.py), so run on
    # the symmetric part (J + J^T)/2 — its lambda_max bounds the real
    # field of values, which is the quantity the Chebyshev window must
    # cover.  For symmetric blocks J^T == J and this is a no-op.
    jacT = jnp.swapaxes(jacL, 0, 1)

    def S(x):
        xs = seam_spread(jnp.where(free, sq * x, 0.0), seam)
        y = 0.5 * (matvec(jacL, xs, lo, hi, k)
                   + matvec(jacT, xs, lo, hi, k))
        y = seam_collect(y, seam)
        return jnp.where(free, sq * y, 0.0)

    idx = sum(jnp.indices(tuple(grid), dtype=jnp.int32))
    sign = jnp.where(idx % 2 == 0, 1.0, -1.0).astype(dtype)
    v = jnp.where(free, sign[None], 0.0)
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
    lam = jnp.max(jnp.linalg.eigvalsh(T.astype(jnp.float32))).astype(
        dtype)
    ok = jnp.isfinite(lam) & (lam > 0)
    return jnp.where(ok, lam,
                     gershgorin(jacL, free, Dinv, lo, hi, k, grid, seam))


def coarsen(jacL, P_embed):
    """Galerkin element-RAP one level down on the lattice:
    (ndl, ndl, *cg) -> (ndl, ndl, *(cg//2)).

    The einsum MUST run at Precision.HIGHEST: a reduced-precision f32
    product (bf16 passes, or TF32 on a GPU) repeated over six
    successive RAPs corrupts the coarse operator enough to make it
    INDEFINITE (a bf16 chain gave lambda_min = -0.12 on the
    Jacobi-scaled refine-6 u-block coarse matrix) — the coarse
    Cholesky then NaNs and the V-cycle returns garbage.  Coarsening
    runs once per Newton solve, so the cost is immaterial."""
    dim = jacL.ndim - 2
    out = 0.0
    for pos, o in enumerate(_offsets(dim)):
        # embedding_matrices orders child positions by geometric bits
        # (pos>>d)&1; _offsets(dim)[a] IS position a in that order
        sl = (slice(None), slice(None)) + tuple(
            slice(oj, None, 2) for oj in o)
        A = jacL[sl]
        P = P_embed[pos].astype(jacL.dtype)
        out = out + jnp.einsum("ai,ab...,bj->ij...", P, A, P,
                               precision=jax.lax.Precision.HIGHEST)
    return out


def coarsen_seam(jacL, P_embed, seam: Seam | None):
    """Galerkin element-RAP one level down on a seam-glued lattice.
    The dead cell row decouples the slabs, so the per-slab RAP of the
    consistent-space element matrices IS the Galerkin coarse operator
    (the duplication-map conjugation S^T . S happens at matvec time;
    see Seam).  The coarse raster keeps its own dead row at s//2."""
    if seam is None:
        return coarsen(jacL, P_embed)
    s = seam.s
    below = coarsen(jacL[:, :, :s], P_embed)
    above = coarsen(jacL[:, :, s + 1:], P_embed)
    dead = jnp.zeros(below.shape[:2] + (1,) + below.shape[3:],
                     below.dtype)
    return jnp.concatenate([below, dead, above], axis=2)


def coarsen_chain(jacL, P_embed, n_levels: int, seam: Seam | None):
    """[coarsest..finest] Galerkin element-matrix levels."""
    jacs = [jacL]
    s = seam
    for _ in range(n_levels - 1):
        jacs.insert(0, coarsen_seam(jacs[0], P_embed, s))
        s = seam_coarse(s)
    return jacs


def _prolong_axis(X, axis):
    """1d Q1 prolongation along one axis: n -> 2n-1 with midpoint
    averages."""
    n = X.shape[axis]
    shp = list(X.shape)
    shp[axis] = 2 * n - 1
    out = jnp.zeros(shp, X.dtype)
    sl = lambda s: tuple(s if j == axis else slice(None)
                         for j in range(X.ndim))
    out = out.at[sl(slice(0, None, 2))].set(X)
    lo = X[sl(slice(0, n - 1))]
    hi = X[sl(slice(1, n))]
    return out.at[sl(slice(1, None, 2))].set(0.5 * (lo + hi))


def _restrict_axis(X, axis):
    """Transpose of _prolong_axis: 2n-1 -> n."""
    sl = lambda s: tuple(s if j == axis else slice(None)
                         for j in range(X.ndim))
    Xc = X[sl(slice(0, None, 2))] + 0.0
    mid = 0.5 * X[sl(slice(1, None, 2))]
    n = Xc.shape[axis]
    Xc = Xc.at[sl(slice(0, n - 1))].add(mid)
    Xc = Xc.at[sl(slice(1, n))].add(mid)
    return Xc


def prolong(Xc, grid, k):
    """Q1 2:1 lattice prolongation (k, *coarsegrid) -> (k, *grid).

    Separable per axis — the tensor-product Q1 embedding factorizes into
    1d interpolations, which keeps every step a strided-slice stream."""
    X = Xc
    for j in range(len(grid)):
        X = _prolong_axis(X, j + 1)
    return X


def restrict(Xf, k):
    """Transpose of prolong: (k, *grid) -> (k, *coarsegrid)."""
    X = Xf
    for j in reversed(range(X.ndim - 1)):
        X = _restrict_axis(X, j + 1)
    return X


def prolong_seam(Xc, grid, k, seam: Seam | None):
    """prolong() on a seam-glued lattice: spread the canonical coarse
    field across its seam, Q1-prolong each slab separately along the
    slit axis (the dead row decouples them), then re-canonicalize.
    On canonical vectors this is exactly the adjoint of restrict_seam
    (tested in tests/test_seam.py)."""
    if seam is None:
        return prolong(Xc, grid, k)
    sc = seam_coarse(seam)
    Xc = seam_spread(Xc, sc)
    below = _prolong_axis(Xc[:, :sc.s + 1], 1)
    above = _prolong_axis(Xc[:, sc.s + 1:], 1)
    X = jnp.concatenate([below, above], axis=1)
    X = _prolong_axis(X, 2)
    return X.at[:, seam.s + 1, :seam.slit_lo].set(0.0)


def restrict_seam(Xf, k, seam: Seam | None):
    """Transpose of prolong_seam: per-slab Q1 restriction followed by
    the coarse-seam collect (S_c^T P^T on canonical vectors)."""
    if seam is None:
        return restrict(Xf, k)
    X = _restrict_axis(Xf, 2)
    below = _restrict_axis(X[:, :seam.s + 1], 1)
    above = _restrict_axis(X[:, seam.s + 1:], 1)
    return seam_collect(jnp.concatenate([below, above], axis=1),
                        seam_coarse(seam))


# ---------------------------------------------------------------------------
# hierarchy
# ---------------------------------------------------------------------------

class LatticeHierarchy(NamedTuple):
    """Static per-epoch data for the lattice GMG solve."""

    grid: tuple             # finest vertex extents (y,x) / (z,y,x)
    n_levels: int           # total levels incl. finest
    vert_idx: jax.Array     # (*grid) int32
    vert_pos: jax.Array     # (n_v,) int32
    # per-level Dirichlet masks, coarsest..finest, as (1|dim, *g)
    dir_u: tuple
    dir_p: tuple
    P_embed: jax.Array      # (nvc+1, ndl, ndl)
    seam: Seam | None = None   # finest-level seam (slit lattices)


def build_lattice_hierarchy(mesh, lay: LatticeLayout, dirichlet_fn,
                            min_coarse: int = 50):
    """Host construction.  Levels halve the cell extents while the
    grid (and, for slit lattices, the seam position) stays 2:1
    coarsenable and the coarse vertex count stays above `min_coarse`."""
    dim = mesh.dim
    grid = lay.grid
    seam = lay.seam
    grids = [grid]
    seams = [seam]
    while _seam_can_coarsen(grids[-1], seams[-1]):
        g_c = _seam_coarse_grid(grids[-1], seams[-1])
        if int(np.prod(g_c)) < min_coarse:
            break
        grids.append(g_c)
        seams.append(seam_coarse(seams[-1]))
    if len(grids) < 2:
        return None
    grids = grids[::-1]     # coarsest..finest
    seams = seams[::-1]

    mask_u, mask_p = dirichlet_fn(mesh)
    mask_u = np.asarray(mask_u).reshape(mesh.n_vertices, dim)
    mask_p = np.asarray(mask_p)
    # geometric Dirichlet masks per level: a coarse-lattice node IS a
    # fine node, so masks inject exactly (slab-aware across the seam).
    # Mirror glued slots carry no DoF: pinned at every level so the
    # free masks keep canonical vectors zero there.
    MU = np.zeros(grid + (dim,), bool)
    MP = np.zeros(grid, bool)
    pos_nd = np.unravel_index(lay.vert_pos, grid)
    MU[pos_nd] = mask_u
    MP[pos_nd] = mask_p
    du = np.moveaxis(MU, -1, 0)                    # (dim, *grid)
    dp = MP[None]                                  # (1, *grid)
    if seam is not None:
        du[:, seam.s + 1, :seam.slit_lo] = True
        dp[:, seam.s + 1, :seam.slit_lo] = True
    dir_u = [jnp.asarray(du)]
    dir_p = [jnp.asarray(dp)]
    for l in range(len(grids) - 1, 0, -1):
        du = _seam_inject_down(du, seams[l])
        dp = _seam_inject_down(dp, seams[l])
        dir_u.insert(0, jnp.asarray(du))
        dir_p.insert(0, jnp.asarray(dp))
    return LatticeHierarchy(
        grid=grid, n_levels=len(grids),
        vert_idx=jnp.asarray(lay.vert_idx),
        vert_pos=jnp.asarray(lay.vert_pos),
        dir_u=tuple(dir_u), dir_p=tuple(dir_p),
        P_embed=jnp.asarray(embedding_matrices(dim), jnp.float32),
        seam=seam)


# ---------------------------------------------------------------------------
# the fused lattice solve
# ---------------------------------------------------------------------------

def _chebyshev(op, Dinv, b, lam_max, degree, rng=20.0):
    upper = 1.2 * lam_max
    lower = lam_max / rng
    theta = 0.5 * (upper + lower)
    delta = 0.5 * (upper - lower)
    r = b
    p = (1.0 / theta) * (Dinv * r)
    x = p
    sigma = theta / delta
    rho_old = 1.0 / sigma
    for _ in range(degree - 1):
        r = b - op(x)
        rho = 1.0 / (2.0 * sigma - rho_old)
        p = (rho * rho_old) * p + (2.0 * rho / delta) * (Dinv * r)
        x = x + p
        rho_old = rho
    return x


class _LOps(NamedTuple):
    jac: jax.Array
    free: jax.Array
    Dinv: jax.Array
    lam: jax.Array
    rng: jax.Array      # Chebyshev smoothing range paired with lam


def _build_block_levels(jacs, dir_u, dir_p, grid, active_L, lo, hi,
                        k, which, sharp: bool = False,
                        seam: Seam | None = None):
    """Per-level (_LOps coarsest..finest) for one block.

    sharp selects the spectral-window regime (multigrid.sharp_spectrum
    policy): Lanczos lambda_max + smoothing range 4 at production
    sizes, the Gershgorin bound + range 20 at golden sizes."""
    from .multigrid import smoothing_range
    rng = jnp.asarray(smoothing_range(sharp), jacs[0].dtype)
    L = len(jacs)
    seams = seam_levels(seam, L)
    acts = [None] * L
    if which == "p":
        a = active_L
        for l in range(L - 1, -1, -1):
            acts[l] = a
            if l:
                a = _seam_inject_down(a, seams[l])
    out = []
    for l in range(L):
        jac = jacs[l]
        g = tuple(c + 1 for c in jac.shape[2:])
        dmask = dir_u[l] if which == "u" else dir_p[l]
        if which == "p":
            free = ~(dmask | acts[l])
        else:
            free = ~dmask & jnp.ones((k,) + g, bool)
        d = seam_collect(block_diag(jac, lo, hi, k, g), seams[l])
        Dinv = jnp.where(free & (jnp.abs(d) > 0), 1.0 / d, 1.0)
        if sharp:
            lam = lanczos_lambda(jac, free, Dinv, lo, hi, k, g,
                                 seam=seams[l])
        else:
            lam = gershgorin(jac, free, Dinv, lo, hi, k, g, seams[l])
        out.append(_LOps(jac=jac, free=free, Dinv=Dinv, lam=lam,
                         rng=rng))
    return out


def _masked_mv(lv: _LOps, lo, hi, k, seam: Seam | None = None):
    def op(X):
        X = seam_spread(jnp.where(lv.free, X, 0.0), seam)
        Y = seam_collect(matvec(lv.jac, X, lo, hi, k), seam)
        return jnp.where(lv.free, Y, 0.0)
    return op


def _coarse_dense_factor(lv0: _LOps, lo, hi, k,
                         seam0: Seam | None = None):
    """Dense Cholesky of the coarsest-level block (Jacobi-scaled, f64).

    With a seam, mirror glued slots alias their canonical slot in the
    scatter index map, so the dense assembly produces S^T A S directly;
    the (contribution-free) mirror slots are pinned to identity by the
    free-mask treatment below."""
    g0 = lv0.free.shape[1:]
    nvert0 = int(np.prod(g0))
    n0 = k * nvert0
    # assemble dense from lattice element matrices via the (tiny)
    # coarsest grid: vertex flat index = comp-major (k, *g0)
    pos = jnp.arange(nvert0).reshape(g0)
    if seam0 is not None:
        pos = pos.at[seam0.s + 1, :seam0.slit_lo].set(
            pos[seam0.s, :seam0.slit_lo])
    offs = _offsets(len(g0))
    wins = jnp.stack([pos[tuple(slice(o[j], g0[j] - 1 + o[j])
                                for j in range(len(g0)))]
                      for o in offs])              # (nvc, *cg0)
    # local dof ldof = a*k + d  ->  flat = d*nvert0 + win[a]
    comp = jnp.arange(k)
    lflat = (comp[None, :, None] * nvert0
             + wins.reshape(len(offs), 1, -1))     # (nvc, k, n_cells0)
    lflat = lflat.reshape((hi - lo), -1)           # (b, n_cells0)
    A = lv0.jac[lo:hi, lo:hi].reshape(hi - lo, hi - lo, -1)
    rows = jnp.broadcast_to(lflat[:, None, :],
                            (hi - lo, hi - lo, lflat.shape[1]))
    cols = jnp.broadcast_to(lflat[None, :, :],
                            (hi - lo, hi - lo, lflat.shape[1]))
    A0 = jnp.zeros((n0, n0), jnp.float64)
    A0 = A0.at[rows.reshape(-1), cols.reshape(-1)].add(
        A.reshape(-1).astype(jnp.float64))
    m = lv0.free.reshape(-1)
    A0 = jnp.where(m[:, None] & m[None, :], A0, 0.0)
    A0 = A0 + jnp.diag(jnp.where(m, 0.0, 1.0))
    s = 1.0 / jnp.sqrt(jnp.abs(jnp.diagonal(A0)))
    A0s = A0 * s[:, None] * s[None, :]
    # SPD-safety shift (preconditioner only, refinement passes correct
    # any inexactness): the element chain feeding A0 is f32, so its
    # rounding can leave lambda_min slightly negative on a unit-diagonal
    # matrix; a 1e-5 relative shift keeps the Cholesky finite without
    # measurably changing the preconditioner
    A0s = A0s + 1e-5 * jnp.eye(n0, dtype=A0s.dtype)
    return jax.scipy.linalg.cho_factor(A0s), s


def make_vcycle(levels, lo, hi, k, degree=2, coarse_factor=None,
                seam: Seam | None = None):
    L = len(levels)
    seams = seam_levels(seam, L)
    if coarse_factor is None:
        cho, cho_scale = _coarse_dense_factor(levels[0], lo, hi, k,
                                              seams[0])
    else:
        cho_c, cho_scale = coarse_factor
        cho = (cho_c, False)
    # the coarse solve runs in the factor's dtype: f64 in the fused
    # solve, f32 in the split-dispatch CG pass (an f32 coarse solve of
    # the Jacobi-scaled system is plenty for a preconditioner)
    cho_dtype = cho[0].dtype
    shape0 = levels[0].free.shape

    def cycle(l, b):
        lv = levels[l]
        b = jnp.where(lv.free, b, 0.0)
        if l == 0:
            bs = cho_scale * b.reshape(-1).astype(cho_dtype)
            x = (cho_scale * jax.scipy.linalg.cho_solve(cho, bs)
                 ).astype(b.dtype).reshape(shape0)
            return jnp.where(lv.free, x, 0.0)
        op = _masked_mv(lv, lo, hi, k, seams[l])
        x = _chebyshev(op, lv.Dinv, b, lv.lam, degree, lv.rng)
        r = b - op(x)
        r_c = restrict_seam(r, k, seams[l])
        e_c = cycle(l - 1, r_c)
        g = lv.free.shape[1:]
        x = x + jnp.where(lv.free, prolong_seam(e_c, g, k, seams[l]),
                          0.0)
        r = b - op(x)
        x = x + _chebyshev(op, lv.Dinv, r, lv.lam, degree, lv.rng)
        return x

    return lambda b: cycle(L - 1, b)


# Above 150k DoFs the solve runs as the split-dispatch variant: same
# algorithm, one device call per CG pass / f64 refinement residual,
# with the f32 chain cast from the stored f64 element matrices.  The
# two variants round differently, so the threshold changes numerics.
# The env knob drives the split paths end-to-end on small problems
# (set it to 0).
import os as _os
FUSED_SOLVE_MAX_DOFS = int(_os.environ.get("CRACKS_TPU_FUSED_MAX_DOFS",
                                           "150000"))
# Spectral-window regime (Lanczos+range4 vs Gershgorin+range20) is
# keyed on problem size — multigrid.sharp_spectrum has the policy and
# the measured ladder (refine 4, total CG its over 2 load steps:
# Gershgorin+range20 109 -> Lanczos+range20 84 -> +range8 66 ->
# +range4 56 -> +range2 58; range 4 keeps margin for rough-coefficient
# split/hetero operators).


def _blk(which, dim):
    """(k, lo, hi) of one block in the corner-major local dof order."""
    nvc = 2 ** dim
    if which == "u":
        return dim, 0, nvc * dim
    return 1, nvc * dim, nvc * (dim + 1)


def solve_lattice(sys, u, phi, phi_old, phi_oold, con, active, rhs_u,
                  rhs_p, with_split):
    """Driver-facing entry: unpacks the System's lattice bundle into the
    jitted fused solve (small problems) or the split-dispatch solve."""
    hier: LatticeHierarchy = sys.lattice_hierarchy
    p = sys.params
    if sys.mesh.n_dofs > FUSED_SOLVE_MAX_DOFS:
        return _solve_split(sys, hier, u, phi, phi_old, phi_oold, con,
                            active, rhs_u, rhs_p, with_split)
    du, dp, its, _rr = _solve_newton_system(
        u, phi, phi_old, phi_oold, sys.ca, sys.lattice_ca32,
        sys.scalars, hier.vert_pos, hier.dir_u, hier.dir_p,
        hier.P_embed, con, active, rhs_u, rhs_p, p.cg_rtol,
        grid=hier.grid, n_levels=hier.n_levels, dim=sys.dim,
        with_split=with_split, monolithic=sys.monolithic,
        seam=hier.seam)
    return du, dp, int(its)


# ---------------------------------------------------------------------------
# split-dispatch variant (large problems)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("grid", "n_levels", "dim",
                                   "with_split", "monolithic", "seam"))
def _prepare(u, phi, phi_old, phi_oold, caL32, sc, P_embed, *, grid,
             n_levels, dim, with_split, monolithic, seam=None):
    """jac32 on the lattice + the Galerkin coarse chain."""
    f32 = lambda x: x.astype(jnp.float32)
    sc32 = physics.Scalars(*(f32(v) for v in sc))
    nvc = 2 ** dim
    ndl = nvc * (dim + 1)
    cgrid = tuple(g - 1 for g in grid)
    jacL = physics.element_matrices(
        f32(u), f32(phi), f32(phi_old), f32(phi_oold), caL32, sc32,
        dim=dim, with_split=with_split, monolithic=monolithic,
        cell_last=True).reshape((ndl, ndl) + cgrid)
    return tuple(coarsen_chain(jacL, P_embed, n_levels, seam))


@partial(jax.jit, static_argnames=("n_levels", "seam"))
def _prepare32_from64(jacL64, P_embed, *, n_levels, seam=None):
    """Branch-consistent f32 chain: CAST the exact f64 element matrices
    and Galerkin-coarsen, instead of rebuilding the physics in f32.

    With the spectral split in the matrix, the element Jacobian takes
    data-dependent branches (eigenvalue-positivity gates, the hand
    linearization cracks.cc:2065-2081); near an eigenvalue sign change
    an f32 rebuild decides those gates DIFFERENTLY than the f64
    operator, making the preconditioner O(1) wrong on the flipped
    cells.  Deep in the softening branch (miehe refine-7 step 23,
    measured) that capped each refinement pass at ~20x and eventually
    REGRESSED the trial residual — the u-solve returned nothing and the
    Newton iteration spun through the dt-cut ladder for hours.  Casting
    the stored f64 matrices makes the f32 chain a ROUNDING of the exact
    operator (branches decided once, in f64): refinement contracts at
    the f32-rounding rate again.  It also deletes the separate f32
    physics build."""
    return tuple(coarsen_chain(jacL64.astype(jnp.float32), P_embed,
                               n_levels, seam))


@partial(jax.jit, static_argnames=("n_levels", "ns_jac", "seam"))
def _prepare32_from64_lat(jacL64, P_embed, *, n_levels, ns_jac=None,
                          seam=None):
    """Sharded-DoF variant of _prepare32_from64 (jacL64 slab-sharded
    along the cell axis; the chain keeps the same shardings)."""
    return _maybe_shard_jacs(
        list(coarsen_chain(jacL64.astype(jnp.float32), P_embed,
                           n_levels, seam)), ns_jac)


@partial(jax.jit, static_argnames=("grid", "which", "dim", "sharp",
                                   "seam"))
def _prepare_levels(jacs, dir_u, dir_p, vert_pos, active, *, grid,
                    which: str, dim: int, sharp: bool = False,
                    seam: Seam | None = None):
    """Per-block level operator data + the coarse dense factor, built
    ONCE per Newton solve (not per restart pass).

    The coarse Cholesky is factored in f64 here and handed to the
    all-f32 CG pass as an f32 factor."""
    k, lo, hi = _blk(which, dim)
    nvert = int(np.prod(grid))
    active_L = jnp.zeros((nvert,), bool).at[vert_pos].set(
        active).reshape((1,) + tuple(grid))
    levels = _build_block_levels(list(jacs), dir_u, dir_p, grid,
                                 active_L, lo, hi, k, which,
                                 sharp=sharp, seam=seam)
    (cho_c, _lower), scale = _coarse_dense_factor(
        levels[0], lo, hi, k, seam_levels(seam, len(levels))[0])
    # drop the python bool from cho_factor's return (it cannot cross the
    # jit boundary); cho_solve is reconstructed with lower=False
    coarse32 = (cho_c.astype(jnp.float32), scale.astype(jnp.float32))
    return tuple(levels), coarse32


def _to_lat(xg, vert_pos, grid, k):
    """Flat global dof vector -> (k, *grid) lattice layout."""
    nvert = int(np.prod(grid))
    if k == 1:
        return jnp.zeros((nvert,), xg.dtype).at[vert_pos].set(
            xg).reshape((1,) + tuple(grid))
    xm = xg.reshape(-1, k)
    X = jnp.zeros((nvert, k), xg.dtype).at[vert_pos].set(xm)
    return jnp.moveaxis(X.reshape(tuple(grid) + (k,)), -1, 0)


def _to_glob(X, vert_pos, k):
    """(k, *grid) lattice layout -> flat global dof vector."""
    if k == 1:
        return X.reshape(-1)[vert_pos]
    Xf = jnp.moveaxis(X, 0, -1).reshape(-1, k)
    return Xf[vert_pos].reshape(-1)


@partial(jax.jit, static_argnames=("grid", "which", "dim"))
def _pass_setup(fin_free, vert_pos, r_g, rtol, target2, *, grid, which,
                dim):
    """f64 -> f32 boundary of one CG pass: residual norm, normalized
    lattice-layout residual and the f32 pass tolerance (one dispatch)."""
    k, _, _ = _blk(which, dim)
    rr0 = jnp.vdot(r_g, r_g).real
    scale = jnp.sqrt(rr0)
    inv_scale = jnp.where(scale > 0, 1.0 / scale, 0.0)
    R0 = _to_lat((r_g * inv_scale).astype(jnp.float32), vert_pos, grid,
                 k)
    R0 = jnp.where(fin_free, R0, 0.0)
    # pass target 3e-7 relative on the NORMALIZED system: each f64
    # refinement restart costs a full f64 operator application plus a
    # new pass setup, so the f32 pass digs as deep as single precision
    # allows; the stagnation guard in _cg_pass32 exits early when the
    # f32 floor is above the target
    tol2 = jnp.asarray(
        jnp.maximum(jnp.maximum(rtol, 3e-7) ** 2,
                    jnp.where(rr0 > 0, target2 / rr0, 1.0)), jnp.float32)
    return R0, scale, tol2, rr0


@partial(jax.jit, static_argnames=("grid", "which", "dim", "degree",
                                   "inner_max", "stall_window", "seam"))
def _cg_pass32(levels, coarse32, R0, tol2, *, grid, which, dim,
               degree=2, inner_max=192, stall_window=16,
               seam: Seam | None = None):
    """One float32 lattice-GMG CG pass on the normalized lattice
    residual; returns (best iterate, inner iterations, best rr), f32.

    Exits when the pass target is met, inner_max is reached, or no
    new best residual appeared within `stall_window` iterations (the
    f32 arithmetic floor — iterations past it cost a full V-cycle each
    without improving the iterate).

    The pass is all-f32 (inputs f32/bool, i32 counter, f32 coarse
    factor); the f64 refinement around it lives in _pass_apply_mat."""
    k, lo, hi = _blk(which, dim)
    levels = list(levels)
    op32 = _masked_mv(levels[-1], lo, hi, k, seam)
    M32 = make_vcycle(levels, lo, hi, k, degree=degree,
                      coarse_factor=coarse32, seam=seam)
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


def _pass_inner_max(n_dofs: int) -> int:
    """Per-pass CG iteration cap of the split solves: above 600k DoFs
    the f64 refinement restarts the pass earlier (changes numerics)."""
    return 192 if n_dofs <= 600_000 else 96


@jax.jit
def _iter_dist(u, phi, phi_old, phi_oold, sc_vec, u0, phi0, phi_old0,
               phi_oold0, sc_vec0):
    """Max-relative distance between everything the element Jacobians
    depend on: the Newton iterate (u scaled by its own magnitude, phi
    by its natural O(1) scale), the previous-step phase fields
    (extrapolation terms, exact comparison — they change only across
    time steps), and the time-dependent scalars.  One dispatch; the
    staleness test for the split-solve operator cache."""
    # floors stay within f32 range and exactly-equal entries are
    # zeroed, so the test never divides 0 by an underflowed guard
    su = jnp.maximum(jnp.max(jnp.abs(u0)), 1e-30)
    d = jnp.max(jnp.abs(u - u0)) / su
    d = jnp.maximum(d, jnp.max(jnp.abs(phi - phi0)))
    d = jnp.maximum(d, jnp.max(jnp.abs(phi_old - phi_old0)))
    d = jnp.maximum(d, jnp.max(jnp.abs(phi_oold - phi_oold0)))
    rel = jnp.abs(sc_vec - sc_vec0) / jnp.maximum(jnp.abs(sc_vec0), 1e-30)
    dsc = jnp.max(jnp.where(sc_vec == sc_vec0, 0.0, rel))
    return jnp.maximum(d, dsc)


def _scalars_vec(sc):
    return jnp.stack([jnp.asarray(v, jnp.float64) for v in sc])


@partial(jax.jit, static_argnames=("grid", "dim", "with_split",
                                   "monolithic"))
def _prepare64(u, phi, phi_old, phi_oold, caL64, sc, *, grid, dim,
               with_split, monolithic):
    """Exact f64 element Jacobians on the lattice raster, built ONCE per
    Newton solve.  The Newton matrix is the exact derivative of the
    residual, so its stored element matrices reproduce the matrix-free
    jvp action to f64 rounding — and a stored-matrix lattice matvec
    costs ~1/6 of a full jvp sweep (one f64 element-matrix build per
    Newton iteration amortizes over the refinement passes)."""
    nvc = 2 ** dim
    ndl = nvc * (dim + 1)
    cgrid = tuple(g - 1 for g in grid)
    return physics.element_matrices(
        u, phi, phi_old, phi_oold, caL64, sc, dim=dim,
        with_split=with_split, monolithic=monolithic,
        cell_last=True).reshape((ndl, ndl) + cgrid)


@partial(jax.jit, static_argnames=("grid", "which", "dim", "seam"))
def _pass_apply_mat(Xb, scale, vert_pos, x_acc, b, jacL64, dir_u_fin,
                    dir_p_fin, active, *, grid, which, dim, seam=None):
    """f32 -> f64 boundary of one CG pass, fused into ONE dispatch:
    un-normalize the pass iterate, form the trial accumulate, apply the
    exact f64 Newton operator (stored f64 element matrices, lattice
    slices — no gathers, no jvp sweep) and compute the trial residual.
    Returns (x_try, r_try, rr_try, jp) with jp = J_pu x_try (consumed by
    the phase-field block's right-hand side when which == 'u')."""
    k, lo, hi = _blk(which, dim)
    nvc = 2 ** dim
    dx = _to_glob(Xb.astype(jnp.float64), vert_pos, k)
    x_try = x_acc + dx * scale
    nvert = int(np.prod(grid))
    active_L = jnp.zeros((nvert,), bool).at[vert_pos].set(
        active).reshape((1,) + tuple(grid))
    free_u = ~dir_u_fin
    free_p = ~(dir_p_fin | active_L)
    free = free_u if which == "u" else free_p
    X = jnp.where(free, _to_lat(x_try, vert_pos, grid, k), 0.0)
    Xs = seam_spread(X, seam)
    Y = jnp.where(free, seam_collect(matvec(jacL64, Xs, lo, hi, k),
                                     seam), 0.0)
    r_try = b - _to_glob(Y, vert_pos, k)
    rr_try = jnp.vdot(r_try, r_try).real
    if which == "u":
        Yp = matvec_block(jacL64, Xs, nvc * dim, nvc * (dim + 1),
                          lo, hi, k, 1)
        jp = _to_glob(jnp.where(free_p, seam_collect(Yp, seam), 0.0),
                      vert_pos, 1)
    else:
        jp = jnp.zeros_like(r_try)
    return x_try, r_try, rr_try, jp


def _solve_split(sys, hier: LatticeHierarchy, u, phi, phi_old, phi_oold,
                 con, active, rhs_u, rhs_p, with_split, passes=3):
    """Host-orchestrated restarted-refinement solve with bounded device
    executions.  Mathematically identical to _solve_newton_system.

    Per CG pass, exactly three device dispatches: _pass_setup (f64
    residual -> normalized f32 lattice rhs), _cg_pass32 (the all-f32
    GMG-preconditioned CG) and _pass_apply_mat (f64 trial accumulate +
    exact stored-matrix Newton-operator residual)."""
    p = sys.params
    rtol = p.cg_rtol
    eps64 = float(np.finfo(np.float64).eps)
    kw = dict(dim=sys.dim, with_split=with_split,
              monolithic=sys.monolithic)
    grid = hier.grid
    seam = hier.seam

    import os
    import time as _wt
    debug = os.environ.get("CRACKS_TPU_DEBUG_SOLVE") == "1"

    def _tick(label, x):
        """Wall-clock print of one dispatch in debug mode."""
        if debug:
            t0 = _wt.perf_counter()
            jax.block_until_ready(x)
            print(f"#     [{label}: {_wt.perf_counter() - t0:6.2f}s]",
                  flush=True)
        return x

    # Operator reuse across PDAS tail iterations: the element Jacobians
    # depend only on (u, phi) within a time step, and iterations at the
    # residual floor move the iterate by ~1e-10 relative — rebuilding
    # the f32 GMG chain + stored f64 operator per iteration buys
    # nothing.  A stale operator with relative error
    # delta makes this an inexact Newton step with O(delta)
    # perturbation; the outer residual assembly and line search are
    # exact, so delta = 1e-6 is far below the line-search acceptance
    # granularity.  (Same idea as the reference's monolithic-variant
    # Jacobian reuse, cracks.cc:3007 nonlinear_rho.)
    _tsplit = _wt.perf_counter()

    def _mark(label):
        if debug:
            print(f"#     [@{label}: "
                  f"{_wt.perf_counter() - _tsplit:6.2f}s]", flush=True)

    cache = getattr(sys, "_split_jac_cache", None)
    sc_vec = _scalars_vec(sys.scalars)
    _mark("scvec")
    jacs = jacL64 = None
    if cache is not None:
        key0, flags0, jacs_c, jacL64_c = cache
        if (flags0 == (with_split, sys.monolithic)
            and all(a.shape == b.shape for a, b in
                    zip(key0, (u, phi, phi_old, phi_oold, sc_vec)))):
            d = float(_iter_dist(u, phi, phi_old, phi_oold, sc_vec,
                                 *key0))
            if d <= float(os.environ.get("CRACKS_TPU_JAC_RTOL",
                                         "1e-6")):
                jacs, jacL64 = jacs_c, jacL64_c
            if debug:
                print(f"#     [jac {'reuse' if jacs is not None else 'rebuild'}:"
                      f" context moved {d:.1e}]", flush=True)
        del jacs_c, jacL64_c
    if jacs is None:
        # free the stale operators BEFORE building replacements:
        # double-buffering the pair (O(100 MB) per 100k cells) is
        # avoidable pressure (the levels cache keys on the jacs tuple
        # identity and pins it, so drop it too)
        sys._split_jac_cache = cache = None
        sys._split_levels_cache = None
        _mark("caches-dropped")
        _p64 = _prepare64(
            u, phi, phi_old, phi_oold, sys.lattice_ca64, sys.scalars,
            grid=grid, **kw)
        _mark("p64-dispatched")
        jacL64 = _tick("prepare64", _p64)
        # branch-consistent f32 chain: cast the f64 matrices (see
        # _prepare32_from64 — an f32 physics rebuild flips spectral-
        # split branches near eigenvalue sign changes)
        jacs = _tick("prepare32", _prepare32_from64(
            jacL64, hier.P_embed, n_levels=hier.n_levels, seam=seam))
        sys._split_jac_cache = ((u, phi, phi_old, phi_oold, sc_vec),
                                (with_split, sys.monolithic),
                                jacs, jacL64)
    _mark("jacs-ready")
    total_its = 0
    last_ju_pu = [None]   # J_pu du of the final accepted u iterate

    def block(which, b):
        nonlocal total_its
        _mark(f"enter-{which}")
        bnorm = float(jnp.sqrt(jnp.vdot(b, b).real))
        _mark(f"bnorm-{which}")
        # Absolute floor: the Newton iteration only needs the linear
        # residual to be invisible at its own convergence bound
        # (lower_bound_newton_residual, an absolute norm the reference
        # also uses, cracks.cc:2971).  Without it, iterations in the
        # PDAS tail hand this solve a right-hand side that is pure f64
        # assembly noise (|b_u| ~ 5e-11 at 1.23M DoFs) and the relative
        # target rtol*|b| burns 30-90 CG iterations per Newton step
        # digging below machine precision for a step nobody consumes.
        atol_newton = 1e-3 * p.lower_bound_newton_residual
        target2 = max(rtol * bnorm, atol_newton,
                      100.0 * eps64 * bnorm) ** 2
        if bnorm * bnorm <= target2:
            # rhs already below the solve target (PDAS-tail u blocks):
            # skip the level build + coarse factorization outright
            return jnp.zeros_like(b)
        # u-block level operators (Chebyshev scalings + coarse factor)
        # depend only on the element Jacobians and the Dirichlet masks —
        # NOT on the active set — so they ride the jac reuse cache; the
        # p-block mask changes with the active set every iteration.
        lv_cache = getattr(sys, "_split_levels_cache", None)
        if which == "u" and lv_cache is not None and lv_cache[0] is jacs:
            levels, coarse32 = lv_cache[1]
        else:
            from .multigrid import sharp_spectrum
            _t0 = _wt.perf_counter() if debug else 0.0
            levels, coarse32 = _prepare_levels(
                jacs, hier.dir_u, hier.dir_p, hier.vert_pos, active,
                grid=grid, which=which, dim=sys.dim,
                sharp=sharp_spectrum(sys.mesh.n_dofs), seam=seam)
            if debug:
                jax.block_until_ready(levels[-1].Dinv)
                print(f"#     [levels/{which}: "
                      f"{_wt.perf_counter() - _t0:6.2f}s]", flush=True)
            if which == "u":
                sys._split_levels_cache = (jacs, (levels, coarse32))
        fin_free = levels[-1].free
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
                setup = _pass_setup(fin_free, hier.vert_pos, r_cur,
                                    rtol, target2_d, grid=grid,
                                    which=which, dim=sys.dim)
            R0, scale_d, tol2, _rr0 = setup
            if debug:
                jax.block_until_ready(R0)
                _t1 = _wt.perf_counter()
            else:
                _t1 = 0.0
            inner_max = _pass_inner_max(sys.mesh.n_dofs)
            # Chebyshev degree: 2 and 3 are iteration-count vs
            # per-cycle-cost tradeoffs (measured refine-5 CPU: 40 its
            # at degree 2 vs 29 at degree 3, ~flop-neutral; block-
            # Jacobi vertex scaling was also tried and changed NOTHING
            # at nu = 0.2, so the point diagonal stays).  The env knob
            # exists to A/B wall-clock on the chip, where the
            # latency-bound coarse levels favor fewer iterations.
            degree = int(os.environ.get("CRACKS_TPU_CHEB_DEGREE", "2"))
            Xb, k_d, _rrb = _cg_pass32(levels, coarse32, R0, tol2,
                                       grid=grid, which=which,
                                       dim=sys.dim, inner_max=inner_max,
                                       degree=degree, seam=seam)
            if debug:
                jax.block_until_ready(Xb)
                _t2 = _wt.perf_counter()
            else:
                _t2 = 0.0
            x_try, r_try, rr_try_d, jp_d = _pass_apply_mat(
                Xb, scale_d, hier.vert_pos, x_acc, b, jacL64,
                hier.dir_u[-1], hier.dir_p[-1], active, grid=grid,
                which=which, dim=sys.dim, seam=seam)
            k_h, rr_try = jax.device_get((k_d, rr_try_d))
            total_its += int(k_h)
            rr_try = float(rr_try)
            if debug:
                _t3 = _wt.perf_counter()
                print(f"#   {which}-pass: its={int(k_h)} "
                      f"rrb32={float(_rrb):.3e} "
                      f"rr {rr_cur:.6e} -> {rr_try:.6e} "
                      f"(target {target2:.3e}) "
                      f"[setup {_t1 - _t0:.2f}s cg {_t2 - _t1:.2f}s "
                      f"apply {_t3 - _t2:.2f}s]", flush=True)
                dump = os.environ.get("CRACKS_TPU_DUMP_FAIL")
                if (dump and float(_rrb) >= 1.0
                        and not os.path.exists(dump)):
                    np.savez(dump, u=np.asarray(u), phi=np.asarray(phi),
                             phi_old=np.asarray(phi_old),
                             phi_oold=np.asarray(phi_oold),
                             active=np.asarray(active),
                             b=np.asarray(b), which=which,
                             scalars=np.asarray(
                                 [float(v) for v in sys.scalars]))
                    print(f"#   dumped failing state -> {dump}",
                          flush=True)
                if float(_rrb) >= 1.0:
                    lams = [float(lv.lam) for lv in levels]
                    dstats = [(float(jnp.min(jnp.abs(jnp.where(
                        lv.free, 1.0 / lv.Dinv, jnp.inf)))),
                        float(jnp.max(jnp.abs(jnp.where(
                            lv.free, 1.0 / lv.Dinv, 0.0)))))
                        for lv in levels]
                    xb_fin = float(jnp.max(jnp.abs(Xb)))
                    nan_j = [bool(jnp.any(~jnp.isfinite(j)))
                             for j in jacs]
                    print(f"#   DIAG {which}: lam={lams}\n"
                          f"#   DIAG diag-min/max={dstats}\n"
                          f"#   DIAG |Xb|max={xb_fin:.3e} "
                          f"jac-nonfinite={nan_j} "
                          f"R0max={float(jnp.max(jnp.abs(R0))):.3e}",
                          flush=True)
            if not np.isfinite(rr_try) or rr_try >= rr_cur:
                break
            progress = rr_try / max(rr_cur, 1e-300)
            x_acc, r_cur = x_try, r_try
            if which == "u":
                last_ju_pu[0] = jp_d
            rr_cur = rr_try
            setup = None
            if rr_cur <= target2 or progress > 0.25:
                break
        return x_acc

    du = block("u", rhs_u)
    _mark("u-done")
    if last_ju_pu[0] is None:
        # no accepted pass: du == 0, so J_pu du == 0
        rhs_p2 = rhs_p
    else:
        rhs_p2 = rhs_p - last_ju_pu[0]
    dp = block("p", rhs_p2)
    _mark("p-done")
    return du, dp, total_its


@partial(jax.jit, static_argnames=("grid", "n_levels", "dim",
                                   "with_split", "monolithic", "degree",
                                   "inner_max", "passes", "seam"))
def _solve_newton_system(u, phi, phi_old, phi_oold, ca64, caL32, sc,
                         vert_pos, dir_u, dir_p, P_embed, con, active,
                         rhs_u, rhs_p, rtol, *, grid, n_levels: int,
                         dim: int, with_split: bool, monolithic: bool,
                         degree: int = 2, inner_max: int = 64,
                         passes: int = 3, seam: Seam | None = None):
    """Fused Newton-system solve on the tensor-grid lattice.

    Same mathematical structure as galerkin.solve_newton_system —
    float32 lattice-GMG-preconditioned CG with float64 matrix-free
    refinement passes — but every Krylov-loop memory access is a
    contiguous slice.  Returns (du, dp, iters, rnorm2) on the free
    subspace in GLOBAL vector layout."""
    from ..ops.constraints import condense_residual, expand_update

    f32 = lambda x: x.astype(jnp.float32)
    sc32 = physics.Scalars(*(f32(v) for v in sc))
    nvc = 2 ** dim
    ndl = nvc * (dim + 1)
    cgrid = tuple(g - 1 for g in grid)
    jacL = physics.element_matrices(
        f32(u), f32(phi), f32(phi_old), f32(phi_oold), caL32, sc32,
        dim=dim, with_split=with_split, monolithic=monolithic,
        cell_last=True).reshape((ndl, ndl) + cgrid)

    # f64 Newton operator, matrix-free (exact; global layout)
    def res64(uu, pp):
        return physics.assemble_residual(
            uu, pp, phi_old, phi_oold, ca64, sc,
            dim=dim, with_split=with_split, monolithic=monolithic)

    _, jvp64 = jax.linearize(res64, u, phi)

    def op64_both(xu, xp):
        eu, ep = expand_update(xu, xp, con, active)
        ju, jp = jvp64(eu, ep)
        return condense_residual(-ju, -jp, con, active)

    # Galerkin coarse lattice matrices
    jacs = coarsen_chain(jacL, P_embed, n_levels, seam)

    # active set on the lattice (phi block)
    active_L = _to_lat(active.astype(jnp.float32), vert_pos, grid,
                       1) > 0.5
    eps64 = float(jnp.finfo(jnp.float64).eps)
    zero_u = jnp.zeros_like(rhs_u)
    zero_p = jnp.zeros_like(rhs_p)

    def block_solve(which, b):
        from .multigrid import sharp_spectrum
        k, lo, hi = _blk(which, dim)
        levels = _build_block_levels(
            jacs, dir_u, dir_p, grid, active_L, lo, hi, k, which,
            sharp=sharp_spectrum(int(np.prod(grid)) * (dim + 1)),
            seam=seam)
        fin = levels[-1]
        M32 = make_vcycle(levels, lo, hi, k, degree=degree, seam=seam)
        op32 = _masked_mv(fin, lo, hi, k, seam)
        if which == "u":
            op64 = lambda x: op64_both(x, zero_p)[0]
        else:
            op64 = lambda x: op64_both(zero_u, x)[1]
        bnorm = jnp.sqrt(jnp.vdot(b, b).real)
        target2 = jnp.maximum(rtol * bnorm, 100.0 * eps64 * bnorm) ** 2

        def one_pass(r0g, rr0):
            scale = jnp.sqrt(rr0)
            inv_scale = jnp.where(scale > 0, 1.0 / scale, 0.0)
            R0 = _to_lat((r0g * inv_scale), vert_pos, grid,
                         k).astype(jnp.float32)
            R0 = jnp.where(fin.free, R0, 0.0)
            tol2 = jnp.asarray(
                jnp.maximum(jnp.maximum(rtol, 1e-5) ** 2,
                            jnp.where(rr0 > 0, target2 / rr0, 1.0)),
                jnp.float32)
            Z0 = M32(R0)

            def cond(s):
                X, R, Z, Pv, rz, kk, Xb, rrb = s
                return (rrb > tol2) & (kk < inner_max)

            def body(s):
                X, R, Z, Pv, rz, kk, Xb, rrb = s
                Ap = op32(Pv)
                denom = jnp.vdot(Pv, Ap)
                alpha = jnp.where(denom != 0, rz / denom, 0.0)
                X = X + alpha * Pv
                R = R - alpha * Ap
                rr = jnp.vdot(R, R).real
                better = rr < rrb
                Xb = jnp.where(better, X, Xb)
                rrb = jnp.where(better, rr, rrb)
                Z = M32(R)
                rz_new = jnp.vdot(R, Z)
                beta = jnp.where(rz != 0, rz_new / rz, 0.0)
                Pv = Z + beta * Pv
                return X, R, Z, Pv, rz_new, kk + 1, Xb, rrb

            s0 = (jnp.zeros_like(R0), R0, Z0, Z0, jnp.vdot(R0, Z0),
                  jnp.asarray(0), jnp.zeros_like(R0),
                  jnp.asarray(1.0, jnp.float32))
            s = jax.lax.while_loop(cond, body, s0)
            dx = _to_glob(s[6].astype(jnp.float64), vert_pos, k) * scale
            return dx, s[5]

        def outer_body(carry):
            x_acc, r_cur, rr_cur, its, done = carry
            dx, kk = one_pass(r_cur, rr_cur)
            x_try = x_acc + dx
            r_try = b - op64(x_try)
            rr_try = jnp.vdot(r_try, r_try).real
            ok = jnp.isfinite(rr_try) & (rr_try < rr_cur)
            x_acc = jnp.where(ok, x_try, x_acc)
            r_cur = jnp.where(ok, r_try, r_cur)
            rr_new = jnp.where(ok, rr_try, rr_cur)
            done = (~ok) | (rr_new <= target2) | (rr_new > 0.25 * rr_cur)
            return x_acc, r_cur, rr_new, its + kk, done

        def outer_cond(carry):
            _, _, rr_cur, its, done = carry
            return (~done) & (rr_cur > target2)

        rr_b = jnp.vdot(b, b).real
        carry = (jnp.zeros_like(b), b, rr_b, jnp.asarray(0),
                 jnp.asarray(False))
        carry = outer_body(carry)
        for _ in range(passes - 1):
            carry = jax.lax.cond(outer_cond(carry), outer_body,
                                 lambda c: c, carry)
        x_acc, r_cur, rr_cur, its, _ = carry
        return x_acc, its, rr_cur

    du, it_u, rr_u = block_solve("u", rhs_u)
    rhs_p2 = rhs_p - op64_both(du, zero_p)[1]
    dp, it_p, rr_p = block_solve("p", rhs_p2)
    return du, dp, it_u + it_p, rr_u + rr_p


# ---------------------------------------------------------------------------
# lattice-resident (sharded-DoF) assembly and solve
# ---------------------------------------------------------------------------
# The replicated-vector production path keeps every DoF vector whole on
# every chip.  The functions below are the sharded-DoF production
# analogue of the reference's owned+ghost distributed vectors
# (cracks.cc:1622-1628 owned/relevant IndexSets, 2147-2154 ghosted
# copies, 2470-2475 compress(add)): state lives in the lattice layout
# (k, *grid), sharded in contiguous slabs along the leading grid axis
# over the device mesh.  Every FEM gather/scatter is a shifted window
# slice, so GSPMD partitions each kernel with a one-row halo exchange
# between devices (collective-permute) — surface traffic, not volume,
# the exact communication pattern of p4est's ghost layer.
#
# Sharding representation: user-facing NamedShardings must divide the
# sharded dimension evenly, and vertex-grid extents are odd (10*2^r+1),
# so every boundary-crossing DoF vector carries PAD ROWS up to
# gyp = ceil(GY/D)*D along the leading grid axis (always zero-filled);
# each jitted kernel slices back to the true grid on entry and re-pads
# + re-constrains on exit.  Element-matrix chains shard without padding
# (cell-grid extents 10*2^r divide the device count in production).


def _unpad_rows(X, gy: int):
    """Drop boundary pad rows: (k, gyp, ...) -> (k, gy, ...)."""
    return X if X.shape[1] == gy else X[:, :gy]


def _pad_rows(X, gyp: int, ns=None):
    """Pad the leading grid axis to gyp rows (zeros) and optionally
    constrain to the slab sharding (the padded extent divides the
    device count, so the NamedSharding is representable)."""
    pad = gyp - X.shape[1]
    if pad:
        w = [(0, 0)] * X.ndim
        w[1] = (0, pad)
        X = jnp.pad(X, w)
    if ns is not None:
        X = jax.lax.with_sharding_constraint(X, ns)
    return X


def _maybe_shard_jacs(jacs, ns_jac):
    """Slab-shard each element-matrix level whose leading cell-grid
    extent divides the device count (coarse levels that do not are tiny
    and stay wherever propagation puts them)."""
    if ns_jac is None:
        return tuple(jacs)
    D = ns_jac.mesh.devices.size
    return tuple(
        jax.lax.with_sharding_constraint(j, ns_jac)
        if j.shape[2] % D == 0 else j for j in jacs)


@partial(jax.jit, static_argnames=("dim", "with_split", "monolithic"))
def lattice_residual(U, P, P_old, P_oold, caL, sc, *, dim,
                     with_split, monolithic):
    """Gather-free residual assembly in lattice layout.

    U (dim, *grid), P/P_old/P_oold (1, *grid); caL are the
    raster-ordered CellArrays (flat cell axis).  Returns (RU (dim,*grid),
    RP (1, *grid)) — the rhs (negative residual), same physics and sign
    convention as physics.assemble_residual (cracks.cc:2393-2430), with
    the cell->vertex gather and the vertex scatter-add expressed as
    2^dim shifted window slices instead of dynamic gathers."""
    nvc = 2 ** dim
    grid = U.shape[1:]
    cgrid = tuple(g - 1 for g in grid)
    n_c = int(np.prod(cgrid))
    u_e = gather_windows(U).reshape(nvc, dim, n_c)
    p_e = gather_windows(P).reshape(nvc, n_c)
    p_old_e = gather_windows(P_old).reshape(nvc, n_c)
    p_oold_e = gather_windows(P_oold).reshape(nvc, n_c)
    ru_e, rp_e = physics._element_residual_cl(
        u_e, p_e, p_old_e, p_oold_e, caL, sc, dim=dim,
        with_split=with_split, monolithic=monolithic)
    RU = scatter_windows(ru_e.reshape((nvc, dim) + cgrid), grid)
    RP = scatter_windows(rp_e.reshape((nvc, 1) + cgrid), grid)
    return RU, RP


def element_matrices_lattice(U, P, P_old, P_oold, caL, sc, *, dim,
                             with_split, monolithic):
    """(ndl, ndl, *cellgrid) element Jacobians from lattice-layout state
    (window gathers instead of dynamic gathers)."""
    nvc = 2 ** dim
    ndl = nvc * (dim + 1)
    grid = U.shape[1:]
    cgrid = tuple(g - 1 for g in grid)
    n_c = int(np.prod(cgrid))
    jac = physics.element_matrices_from_cellvals(
        gather_windows(U).reshape(nvc, dim, n_c),
        gather_windows(P).reshape(nvc, n_c),
        gather_windows(P_old).reshape(nvc, n_c),
        gather_windows(P_oold).reshape(nvc, n_c),
        caL, sc, nvc=nvc, dim=dim, with_split=with_split,
        monolithic=monolithic)
    return jac.reshape((ndl, ndl) + cgrid)


@partial(jax.jit, static_argnames=("grid", "dim", "n_levels",
                                   "with_split", "monolithic", "ns_jac",
                                   "seam"))
def _prepare_lat(U, P, P_old, P_oold, caL32, sc, P_embed, *, grid, dim,
                 n_levels, with_split, monolithic, ns_jac=None,
                 seam=None):
    """jac32 chain from (padded) lattice-layout state (sharded-DoF
    variant of _prepare).  Canonical seam state is spread so the
    window gathers see the shared values on both slit lips."""
    gy = grid[0]
    f32 = lambda x: seam_spread(_unpad_rows(x, gy), seam).astype(
        jnp.float32)
    sc32 = physics.Scalars(*(x.astype(jnp.float32) for x in sc))
    jacL = element_matrices_lattice(
        f32(U), f32(P), f32(P_old), f32(P_oold), caL32, sc32, dim=dim,
        with_split=with_split, monolithic=monolithic)
    return _maybe_shard_jacs(
        list(coarsen_chain(jacL, P_embed, n_levels, seam)), ns_jac)


@partial(jax.jit, static_argnames=("grid", "dim", "with_split",
                                   "monolithic", "ns_jac", "seam"))
def _prepare64_lat(U, P, P_old, P_oold, caL64, sc, *, grid, dim,
                   with_split, monolithic, ns_jac=None, seam=None):
    """Exact f64 element Jacobians from (padded) lattice-layout state
    (sharded-DoF variant of _prepare64)."""
    gy = grid[0]
    up = lambda x: seam_spread(_unpad_rows(x, gy), seam)
    jac = element_matrices_lattice(
        up(U), up(P), up(P_old), up(P_oold), caL64, sc, dim=dim,
        with_split=with_split, monolithic=monolithic)
    return _maybe_shard_jacs([jac], ns_jac)[0]


@partial(jax.jit, static_argnames=("grid", "which", "dim", "sharp",
                                   "seam"))
def _prepare_levels_lat(jacs, dir_u, dir_p, active_pad, *, grid,
                        which: str, dim: int, sharp: bool = False,
                        seam: Seam | None = None):
    """Per-block level operator data from a (padded) lattice-layout
    active mask (sharded-DoF variant of _prepare_levels)."""
    k, lo, hi = _blk(which, dim)
    active_L = _unpad_rows(active_pad, grid[0])
    levels = _build_block_levels(list(jacs), dir_u, dir_p, grid,
                                 active_L, lo, hi, k, which,
                                 sharp=sharp, seam=seam)
    (cho_c, _lower), scale = _coarse_dense_factor(
        levels[0], lo, hi, k, seam_levels(seam, len(levels))[0])
    coarse32 = (cho_c.astype(jnp.float32), scale.astype(jnp.float32))
    return tuple(levels), coarse32


@partial(jax.jit, static_argnames=("grid", "which", "dim"))
def _pass_setup_lat(fin_free, R_pad, rtol, target2, *, grid, which, dim):
    """f64 -> f32 boundary of one CG pass on a (padded) lattice-layout
    residual (sharded-DoF variant of _pass_setup; one dispatch).  The
    returned R0 is TRUE-shaped (consumed by _cg_pass32 against the
    level masks)."""
    R = _unpad_rows(R_pad, grid[0])
    rr0 = jnp.sum(R * R)
    scale = jnp.sqrt(rr0)
    inv_scale = jnp.where(scale > 0, 1.0 / scale, 0.0)
    R0 = jnp.where(fin_free, (R * inv_scale).astype(jnp.float32), 0.0)
    tol2 = jnp.asarray(
        jnp.maximum(jnp.maximum(rtol, 3e-7) ** 2,
                    jnp.where(rr0 > 0, target2 / rr0, 1.0)), jnp.float32)
    return R0, scale, tol2, rr0


@partial(jax.jit, static_argnames=("grid", "which", "dim", "gyp", "ns",
                                   "seam"))
def _pass_apply_mat_lat(Xb, scale, X_acc, B, jacL64, free_u, free_p, *,
                        grid, which, dim, gyp, ns=None, seam=None):
    """f32 -> f64 boundary of one CG pass, lattice layout throughout
    (sharded-DoF variant of _pass_apply_mat): trial accumulate, exact
    stored-f64 lattice matvec, trial residual.  X_acc/B arrive padded;
    Xb is the true-shaped f32 pass iterate.  Returns padded
    (X_try, R_try, rr_try, JP) with JP = J_pu X_try for which == 'u'."""
    k, lo, hi = _blk(which, dim)
    nvc = 2 ** dim
    gy = grid[0]
    x_acc = _unpad_rows(X_acc, gy)
    b = _unpad_rows(B, gy)
    X_try = x_acc + Xb.astype(jnp.float64) * scale
    free = free_u if which == "u" else free_p
    Xs = seam_spread(jnp.where(free, X_try, 0.0), seam)
    Y = jnp.where(free, seam_collect(matvec(jacL64, Xs, lo, hi, k),
                                     seam), 0.0)
    R_try = b - Y
    rr_try = jnp.sum(R_try * R_try)
    if which == "u":
        Yp = matvec_block(jacL64, Xs, nvc * dim, nvc * (dim + 1),
                          lo, hi, k, 1)
        JP = jnp.where(free_p, seam_collect(Yp, seam), 0.0)
    else:
        JP = jnp.zeros((1,) + tuple(grid), jnp.float64)
    return (_pad_rows(X_try, gyp, ns), _pad_rows(R_try, gyp, ns),
            rr_try, _pad_rows(JP, gyp, ns))


def _solve_split_lat(sys, hier: LatticeHierarchy, U, P, P_old, P_oold,
                     active, RHS_U, RHS_P, with_split, passes=3):
    """Host-orchestrated restarted-refinement solve on LATTICE-LAYOUT
    sharded state: the sharded-DoF production solve.  Mathematically
    identical to _solve_split (same f32 GMG-CG pass + f64 stored-matrix
    refinement), but every DoF vector stays (k, gyp, ...) — row-padded
    and slab-sharded along the leading grid axis when the System
    carries a device mesh — and no flat replicated copies are formed.
    Returns (DU, DP, total_its) padded, on the free subspace."""
    p = sys.params
    rtol = p.cg_rtol
    eps64 = float(np.finfo(np.float64).eps)
    kw = dict(dim=sys.dim, with_split=with_split,
              monolithic=sys.monolithic)
    grid = hier.grid
    gy = grid[0]
    gyp = U.shape[1]
    ns = sys.lat_ns()
    ns_jac = sys.lat_ns_jac()
    dir_u_fin = hier.dir_u[-1]
    dir_p_fin = hier.dir_p[-1]
    active_L = _unpad_rows(active, gy)
    free_u_fin = ~dir_u_fin
    free_p_fin = ~(dir_p_fin | active_L)

    import os
    debug = os.environ.get("CRACKS_TPU_DEBUG_SOLVE") == "1"

    # operator reuse across PDAS tail iterations (same contract as
    # _solve_split: staleness test via _iter_dist, delta <= 1e-6)
    cache = getattr(sys, "_split_jac_cache_lat", None)
    sc_vec = _scalars_vec(sys.scalars)
    jacs = jacL64 = None
    if cache is not None:
        key0, flags0, jacs_c, jacL64_c = cache
        if (flags0 == (with_split, sys.monolithic)
            and all(a.shape == b.shape for a, b in
                    zip(key0, (U, P, P_old, P_oold, sc_vec)))):
            d = float(_iter_dist(U, P, P_old, P_oold, sc_vec, *key0))
            if d <= float(os.environ.get("CRACKS_TPU_JAC_RTOL",
                                         "1e-6")):
                jacs, jacL64 = jacs_c, jacL64_c
            if debug:
                print(f"#     [jac-lat "
                      f"{'reuse' if jacs is not None else 'rebuild'}:"
                      f" context moved {d:.1e}]", flush=True)
        del jacs_c, jacL64_c
    if jacs is None:
        sys._split_jac_cache_lat = cache = None
        sys._split_levels_cache_lat = None
        jacL64 = _prepare64_lat(U, P, P_old, P_oold, sys.lattice_ca64,
                                sys.scalars, grid=grid, ns_jac=ns_jac,
                                seam=hier.seam, **kw)
        # branch-consistent f32 chain (see _prepare32_from64): cast the
        # exact f64 matrices instead of rebuilding the physics in f32
        jacs = _prepare32_from64_lat(jacL64, hier.P_embed,
                                     n_levels=hier.n_levels,
                                     ns_jac=ns_jac, seam=hier.seam)
        sys._split_jac_cache_lat = ((U, P, P_old, P_oold, sc_vec),
                                    (with_split, sys.monolithic),
                                    jacs, jacL64)
    total_its = 0
    last_ju_pu = [None]

    def block(which, B):
        nonlocal total_its
        bnorm = float(jnp.sqrt(jnp.sum(B * B)))   # pad rows are zero
        atol_newton = 1e-3 * p.lower_bound_newton_residual
        target2 = max(rtol * bnorm, atol_newton,
                      100.0 * eps64 * bnorm) ** 2
        if bnorm * bnorm <= target2:
            return jnp.zeros_like(B)
        lv_cache = getattr(sys, "_split_levels_cache_lat", None)
        if which == "u" and lv_cache is not None and lv_cache[0] is jacs:
            levels, coarse32 = lv_cache[1]
        else:
            from .multigrid import sharp_spectrum
            levels, coarse32 = _prepare_levels_lat(
                jacs, hier.dir_u, hier.dir_p, active, grid=grid,
                which=which, dim=sys.dim,
                sharp=sharp_spectrum(sys.mesh.n_dofs), seam=hier.seam)
            if which == "u":
                sys._split_levels_cache_lat = (jacs, (levels, coarse32))
        fin_free = levels[-1].free
        target2_d = jnp.asarray(target2)
        X_acc = jnp.zeros_like(B)
        R_cur = B
        rr_cur = bnorm * bnorm
        setup = None
        for _ in range(passes):
            if rr_cur <= target2:
                break
            if setup is None:
                setup = _pass_setup_lat(fin_free, R_cur, rtol,
                                        target2_d, grid=grid,
                                        which=which, dim=sys.dim)
            R0, scale_d, tol2, _rr0 = setup
            inner_max = _pass_inner_max(sys.mesh.n_dofs)
            degree = int(os.environ.get("CRACKS_TPU_CHEB_DEGREE", "2"))
            Xb, k_d, _rrb = _cg_pass32(levels, coarse32, R0, tol2,
                                       grid=grid, which=which,
                                       dim=sys.dim, inner_max=inner_max,
                                       degree=degree, seam=hier.seam)
            X_try, R_try, rr_try_d, JP_d = _pass_apply_mat_lat(
                Xb, scale_d, X_acc, B, jacL64, free_u_fin, free_p_fin,
                grid=grid, which=which, dim=sys.dim, gyp=gyp, ns=ns,
                seam=hier.seam)
            k_h, rr_try = jax.device_get((k_d, rr_try_d))
            total_its += int(k_h)
            rr_try = float(rr_try)
            if debug:
                print(f"#   {which}-pass(lat): its={int(k_h)} "
                      f"rrb32={float(_rrb):.3e} "
                      f"rr {rr_cur:.6e} -> {rr_try:.6e} "
                      f"(target {target2:.3e})", flush=True)
            if not np.isfinite(rr_try) or rr_try >= rr_cur:
                break
            progress = rr_try / max(rr_cur, 1e-300)
            X_acc, R_cur = X_try, R_try
            if which == "u":
                last_ju_pu[0] = JP_d
            rr_cur = rr_try
            setup = None
            if rr_cur <= target2 or progress > 0.25:
                break
        return X_acc

    DU = block("u", RHS_U)
    RHS_P2 = RHS_P if last_ju_pu[0] is None else RHS_P - last_ju_pu[0]
    DP = block("p", RHS_P2)
    return DU, DP, total_its
