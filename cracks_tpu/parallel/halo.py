"""Halo-exchange domain decomposition with SHARDED DoF vectors.

The replicated-vector SPMD path (parallel/sharding.py) keeps every DoF
vector whole on every chip and combines raw residuals with a full-size
``psum`` — exact, but each chip stores O(n_dofs) state and every combine
moves O(n_dofs) between devices.  This module is the JAX analogue of
the reference's ghosted Trilinos vectors + compress(add)
(cracks.cc:2147-2154, 2470-2475): each shard OWNS a contiguous
Morton-range of cells and the vertices attached to them, stores only its
own+ghost DoFs, and all inter-chip traffic is a single small collective
over the *partition boundary* pool:

 * ghost read  (``rel_solution = solution``, cracks.cc:2147): owners
   publish their boundary values into a (B,) pool, one ``psum`` over the
   device axis makes the pool whole, ghosts gather from it.  B is the
   number of interface vertices — O(sqrt(n/D) * D) in 2d — so the wire
   traffic is the surface, not the volume.
 * combine  (``compress(VectorOperation::add)``, cracks.cc:2470): every
   shard scatter-adds its partial sums for interface vertices into the
   pool, one ``psum`` totals them, owners read their rows back.

Both directions are the SAME primitive (scatter-add into pool, psum,
gather), mirroring how p4est's ghost layer is one neighbor exchange
pattern used in both directions.

Hanging-node constraints ARE distributed: each shard's vertex pool is
extended with the masters of every locally-seen hanging vertex, the Q1
interpolation H and its transpose H^T are applied shard-locally (the
flat ops/constraints.py stencils in local indices), and the same pool
exchange combines the distributed master rows — deal.II's ghosted
AffineConstraints::distribute_local_to_global pattern
(cracks.cc:2439-2464) on the pool primitive.  Like the flat path,
constraint chains (a master that is itself hanging) are assumed absent
(the 2:1 CONNECT_FULL balance guarantees it; mesh.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import physics

AXIS = "cells"


class HaloArrays(NamedTuple):
    """Device arrays; every leaf has leading axis D (sharded over the
    device mesh) except the replicated shape table inside `ca`."""

    ca: physics.CellArrays     # per-shard local cell arrays (D, ..., C)
    own_mask_p: jax.Array      # (D, n_loc) bool — slot owned (not pad)
    loc2glob: jax.Array        # (D, n_loc) int32 — global vertex (or n_v)
    loc2pool: jax.Array        # (D, n_loc) int32 — pool slot (or B)
    is_ghost: jax.Array        # (D, n_loc) bool
    # hanging-node stencils in LOCAL slot indices (padded rows point at
    # the trash slot with zero weights)
    hang_child: jax.Array      # (D, H) int32
    hang_masters: jax.Array    # (D, H, 4) int32
    hang_weights: jax.Array    # (D, H, 4) float64
    hang_mask: jax.Array       # (D, n_loc) bool — slot is hanging


@dataclass(frozen=True)
class HaloPartition:
    arrays: HaloArrays
    n_loc: int                 # local vertex slots per shard (incl trash)
    n_pool: int                # B interface vertices
    n_shards: int
    dim: int
    n_vertices: int            # global count (for redistribution utils)


def _local_cell_arrays(mesh, lam, mu, cells_s, g2l):
    """Per-shard cell tables over LOCAL vertex indices (host numpy)."""
    from ..fem import element_tables, cell_geometry

    t = element_tables(mesh.dim)
    cc = mesh.cell_coords[cells_s]
    JxW, grads = cell_geometry(cc, t)
    dim = mesh.dim
    nvc = mesh.cell2vert.shape[1]
    c2v_loc = g2l[mesh.cell2vert[cells_s]].astype(np.int64)   # (c, nvc)
    gather_u = (c2v_loc[:, :, None] * dim
                + np.arange(dim)[None, None, :]).reshape(len(cells_s),
                                                         nvc * dim).T
    lam_arr = np.broadcast_to(np.asarray(lam, np.float64),
                              (mesh.n_cells,))[cells_s]
    mu_arr = np.broadcast_to(np.asarray(mu, np.float64),
                             (mesh.n_cells,))[cells_s]
    return [gather_u, c2v_loc.T, JxW.T, np.transpose(grads, (1, 2, 3, 0)),
            lam_arr, mu_arr, 1.0 / mesh.diameters[cells_s] ** 2]


def build_halo_partition(mesh, lam, mu, n_shards: int,
                         dtype=jnp.float64) -> HaloPartition:
    """Host-side construction: contiguous Morton cell ranges (cells are
    already space-filling-curve sorted by the Forest), vertex ownership
    by lowest cell-touching shard, boundary pool = vertices seen by >1
    shard.  On meshes with hanging nodes, each shard's vertex set is
    extended with the masters of its locally-seen hanging vertices so
    the Q1 constraint H / H^T is shard-local; "seen by" (for the pool)
    uses the extended sets."""
    n_c, n_v, dim = mesh.n_cells, mesh.n_vertices, mesh.dim
    bounds = np.linspace(0, n_c, n_shards + 1).astype(np.int64)
    shard_of_cell = np.searchsorted(bounds[1:], np.arange(n_c), "right")

    # vertex -> masters map for hanging vertices (assert no chains)
    n_h = len(mesh.hang_child)
    hang_of = np.full(n_v, -1, np.int64)
    if n_h:
        hang_of[mesh.hang_child] = np.arange(n_h)
        if (hang_of[mesh.hang_masters.ravel()] >= 0).any():
            raise ValueError("hanging-constraint chain (a master is "
                             "itself hanging) — unsupported, like the "
                             "flat path")

    # per-shard extended vertex sets (cells' vertices + hang masters)
    vert_sets = []
    for s in range(n_shards):
        cells_s = np.arange(bounds[s], bounds[s + 1])
        verts_s = np.unique(mesh.cell2vert[cells_s])
        if n_h:
            h = hang_of[verts_s]
            hm = mesh.hang_masters[h[h >= 0]]
            verts_s = np.unique(np.concatenate([verts_s, hm.ravel()]))
        vert_sets.append(verts_s)

    # ownership by lowest CELL-touching shard; pool = seen by >1 shard
    # under the extended sets
    smin = np.full(n_v, n_shards, np.int64)
    np.minimum.at(smin, mesh.cell2vert.ravel(),
                  np.repeat(shard_of_cell, mesh.cell2vert.shape[1]))
    owner = smin
    seen = np.zeros(n_v, np.int64)
    for verts_s in vert_sets:
        seen[verts_s] += 1
    pool_vert = np.nonzero(seen > 1)[0]
    B = len(pool_vert)
    pool_slot = np.full(n_v, B, np.int64)
    pool_slot[pool_vert] = np.arange(B)

    shards = []
    C_max = V_max = H_max = 0
    hang_mask_g = np.zeros(n_v, bool)
    if n_h:
        hang_mask_g[mesh.hang_child] = True
    for s in range(n_shards):
        cells_s = np.arange(bounds[s], bounds[s + 1])
        verts_s = vert_sets[s]
        own = verts_s[owner[verts_s] == s]
        ghost = verts_s[owner[verts_s] != s]
        hloc = np.nonzero(hang_mask_g[verts_s])[0]
        shards.append((cells_s, own, ghost, verts_s[hloc]))
        C_max = max(C_max, len(cells_s))
        V_max = max(V_max, len(own) + len(ghost))
        H_max = max(H_max, len(hloc))
    n_loc = V_max + 1          # + trash slot (padded cells point here)

    ca_parts = []
    own_mask = np.zeros((n_shards, n_loc), bool)
    loc2glob = np.full((n_shards, n_loc), n_v, np.int32)
    loc2pool = np.full((n_shards, n_loc), B, np.int32)
    is_ghost = np.zeros((n_shards, n_loc), bool)
    hang_mask_l = np.zeros((n_shards, n_loc), bool)
    h_child = np.full((n_shards, H_max), n_loc - 1, np.int32)
    h_masters = np.full((n_shards, H_max, 4), n_loc - 1, np.int32)
    h_weights = np.zeros((n_shards, H_max, 4))
    for s, (cells_s, own, ghost, hverts) in enumerate(shards):
        g2l = np.full(n_v + 1, n_loc - 1, np.int64)   # default: trash
        g2l[own] = np.arange(len(own))
        g2l[ghost] = len(own) + np.arange(len(ghost))
        own_mask[s, : len(own)] = True
        lv = np.concatenate([own, ghost])
        loc2glob[s, : len(lv)] = lv
        loc2pool[s, : len(lv)] = pool_slot[lv]
        is_ghost[s, len(own): len(lv)] = True
        hang_mask_l[s, g2l[hverts]] = True
        if len(hverts):
            hidx = hang_of[hverts]
            h_child[s, : len(hverts)] = g2l[hverts]
            h_masters[s, : len(hverts)] = g2l[mesh.hang_masters[hidx]]
            h_weights[s, : len(hverts)] = mesh.hang_weights[hidx]
        parts = _local_cell_arrays(mesh, lam, mu, cells_s, g2l)
        pad = C_max - len(cells_s)
        if pad:
            fills = [(n_loc - 1) * dim, n_loc - 1, 0, 0, 1, 1, 1]
            for i, (a, fill) in enumerate(zip(parts, fills)):
                widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
                parts[i] = np.pad(a, widths, constant_values=fill)
        ca_parts.append(parts)

    from ..fem import element_tables
    shape_v = element_tables(dim).shape_v
    stack = lambda i, dt: jnp.asarray(
        np.stack([p[i] for p in ca_parts]), dtype=dt)
    ca = physics.CellArrays(
        gather_u=stack(0, jnp.int32), gather_p=stack(1, jnp.int32),
        JxW=stack(2, dtype), grads=stack(3, dtype),
        shape_v=jnp.asarray(shape_v, dtype),
        lam=stack(4, dtype), mu=stack(5, dtype),
        inv_diam2=stack(6, dtype))
    arrays = HaloArrays(
        ca=ca, own_mask_p=jnp.asarray(own_mask),
        loc2glob=jnp.asarray(loc2glob), loc2pool=jnp.asarray(loc2pool),
        is_ghost=jnp.asarray(is_ghost),
        hang_child=jnp.asarray(h_child),
        hang_masters=jnp.asarray(h_masters),
        hang_weights=jnp.asarray(h_weights),
        hang_mask=jnp.asarray(hang_mask_l))
    return HaloPartition(arrays=arrays, n_loc=n_loc, n_pool=B,
                         n_shards=n_shards, dim=dim, n_vertices=n_v)


def halo_specs() -> HaloArrays:
    """PartitionSpecs for HaloArrays over a 1-D ("cells",) device mesh."""
    ca_spec = physics.CellArrays(
        gather_u=P(AXIS), gather_p=P(AXIS), JxW=P(AXIS), grads=P(AXIS),
        shape_v=P(), lam=P(AXIS), mu=P(AXIS), inv_diam2=P(AXIS))
    return HaloArrays(ca=ca_spec, own_mask_p=P(AXIS), loc2glob=P(AXIS),
                      loc2pool=P(AXIS), is_ghost=P(AXIS),
                      hang_child=P(AXIS), hang_masters=P(AXIS),
                      hang_weights=P(AXIS), hang_mask=P(AXIS))


def device_put_partition(part: HaloPartition, mesh: Mesh) -> HaloPartition:
    arrs = jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        part.arrays, halo_specs())
    return HaloPartition(arrays=arrs, n_loc=part.n_loc,
                         n_pool=part.n_pool, n_shards=part.n_shards,
                         dim=part.dim, n_vertices=part.n_vertices)


# ---------------------------------------------------------------------------
# global <-> local redistribution (host/test utility)
# ---------------------------------------------------------------------------

def global_to_local_p(part: HaloPartition, x) -> np.ndarray:
    xe = np.concatenate([np.asarray(x), [0.0]])
    return xe[np.asarray(part.arrays.loc2glob)]


def global_to_local_u(part: HaloPartition, x) -> np.ndarray:
    l2g = np.asarray(part.arrays.loc2glob)
    xe = np.concatenate([np.asarray(x).reshape(part.n_vertices, part.dim),
                         np.zeros((1, part.dim))])
    return xe[l2g].reshape(part.n_shards, -1)


def local_to_global_p(part: HaloPartition, xl) -> np.ndarray:
    l2g = np.asarray(part.arrays.loc2glob)
    mask = np.asarray(part.arrays.own_mask_p)
    out = np.zeros(part.n_vertices)
    out[l2g[mask]] = np.asarray(xl)[mask]
    return out


def local_to_global_u(part: HaloPartition, xl) -> np.ndarray:
    l2g = np.asarray(part.arrays.loc2glob)
    mask = np.asarray(part.arrays.own_mask_p)
    out = np.zeros((part.n_vertices, part.dim))
    xs = np.asarray(xl).reshape(part.n_shards, -1, part.dim)
    for s in range(part.n_shards):
        out[l2g[s][mask[s]]] = xs[s][mask[s]]
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# device-side halo primitives (run INSIDE shard_map)
# ---------------------------------------------------------------------------

def _pool_exchange(vals, pool_idx, n_pool, comps):
    """Scatter-add local (n_loc, comps) values into the shared pool,
    psum whole across shards, return (n_pool+1, comps)."""
    pool = jnp.zeros((n_pool + 1, comps), vals.dtype)
    pool = pool.at[pool_idx].add(vals)
    return jax.lax.psum(pool, AXIS)


def make_halo_ops(part: HaloPartition):
    """Shard-level ghost-read / combine closures (statics captured)."""
    n_pool, n_loc, dim = part.n_pool, part.n_loc, part.dim

    def ghost_read(x, arr: HaloArrays, comps):
        xm = x.reshape(n_loc, comps)
        own = jnp.where(arr.own_mask_p[0][:, None], xm, 0.0)
        pool = _pool_exchange(own, arr.loc2pool[0], n_pool, comps)
        xm = jnp.where(arr.is_ghost[0][:, None], pool[arr.loc2pool[0]],
                       xm)
        return xm.reshape(x.shape)

    def combine(r, arr: HaloArrays, comps):
        rm = r.reshape(n_loc, comps)
        pool = _pool_exchange(rm, arr.loc2pool[0], n_pool, comps)
        on_pool = arr.loc2pool[0] < n_pool
        rm = jnp.where(on_pool[:, None], pool[arr.loc2pool[0]], rm)
        rm = jnp.where(arr.own_mask_p[0][:, None], rm, 0.0)
        return rm.reshape(r.shape)

    ghost_read_p = lambda x, arr: ghost_read(x, arr, 1)
    ghost_read_u = lambda x, arr: ghost_read(x, arr, dim)
    combine_p = lambda r, arr: combine(r, arr, 1)
    combine_u = lambda r, arr: combine(r, arr, dim)
    return ghost_read_u, ghost_read_p, combine_u, combine_p


def _shard_ca(ca: physics.CellArrays) -> physics.CellArrays:
    """Inside shard_map each leading-D leaf arrives (1, ...); drop it."""
    return physics.CellArrays(
        gather_u=ca.gather_u[0], gather_p=ca.gather_p[0], JxW=ca.JxW[0],
        grads=ca.grads[0], shape_v=ca.shape_v, lam=ca.lam[0],
        mu=ca.mu[0], inv_diam2=ca.inv_diam2[0])


def halo_residual_fn(mesh: Mesh, part: HaloPartition, *, with_split: bool,
                     monolithic: bool):
    """SPMD residual on sharded DoF vectors.

    Inputs (D, n_loc*dim) / (D, n_loc) sharded; ghosts refreshed
    internally; outputs owner-combined (ghost + pad slots zero)."""
    dim = part.dim
    gr_u, gr_p, cb_u, cb_p = make_halo_ops(part)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), halo_specs(),
                       P()),
             out_specs=(P(AXIS), P(AXIS)))
    def fn(u, phi, phi_old, phi_oold, arr, sc):
        ca = _shard_ca(arr.ca)
        u = gr_u(u[0], arr)
        phi = gr_p(phi[0], arr)
        phi_old = gr_p(phi_old[0], arr)
        phi_oold = gr_p(phi_oold[0], arr)
        ru, rp = physics.assemble_residual(
            u, phi, phi_old, phi_oold, ca, sc,
            dim=dim, with_split=with_split, monolithic=monolithic)
        return cb_u(ru, arr)[None], cb_p(rp, arr)[None]

    return lambda u, phi, po, poo, sc: fn(u, phi, po, poo, part.arrays,
                                          sc)


def halo_jacobi_cg_fn(mesh: Mesh, part: HaloPartition, *,
                      with_split: bool, monolithic: bool,
                      maxiter: int = 400):
    """Distributed block-triangular Jacobi-PCG with sharded vectors.

    The quasi-monolithic Jacobian is block lower triangular (u rows see
    no phi columns, cracks.cc:2353-2366), so the solve is two SPD CGs:
    A_uu du = b_u, then A_pp dp = b_p - A_pu du — exactly the
    single-device solver structure (solvers/linear.py), with matvec =
    jvp of the halo residual and dots = psum over owned slots.
    free_u/free_p are local (D, ...) bool masks (Dirichlet + active
    set).  Returns (du, dp, iters, rr)."""
    dim = part.dim
    gr_u, gr_p, cb_u, cb_p = make_halo_ops(part)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), halo_specs(),
                       P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
             out_specs=(P(AXIS), P(AXIS), P(), P()))
    def fn(u, phi, phi_old, phi_oold, arr, sc, rhs_u, rhs_p,
           free_u, free_p, rtol):
        ca = _shard_ca(arr.ca)
        u = gr_u(u[0], arr)
        phi = gr_p(phi[0], arr)
        phi_old = gr_p(phi_old[0], arr)
        phi_oold = gr_p(phi_oold[0], arr)
        rhs_u, rhs_p = rhs_u[0], rhs_p[0]
        free_u, free_p = free_u[0], free_p[0]

        own_u = jnp.repeat(arr.own_mask_p[0], dim) & free_u
        own_p = arr.own_mask_p[0] & free_p

        def res(uu, pp):
            return physics.assemble_residual(
                uu, pp, phi_old, phi_oold, ca, sc,
                dim=dim, with_split=with_split, monolithic=monolithic)

        def jv(du, dp):
            du = gr_u(jnp.where(own_u, du, 0.0), arr)
            dp = gr_p(jnp.where(own_p, dp, 0.0), arr)
            _, (ju, jp) = jax.jvp(res, (u, phi), (du, dp))
            ju = cb_u(-ju, arr)
            jp = cb_p(-jp, arr)
            return (jnp.where(own_u, ju, 0.0), jnp.where(own_p, jp, 0.0))

        dgu, dgp = physics.jacobi_diagonal_approx(
            u, phi, phi_old, phi_oold, ca, sc, dim=dim,
            monolithic=monolithic)
        dgu = cb_u(dgu, arr)
        dgp = cb_p(dgp, arr)
        Minv_u = jnp.where(own_u & (jnp.abs(dgu) > 0), 1.0 / dgu, 1.0)
        Minv_p = jnp.where(own_p & (jnp.abs(dgp) > 0), 1.0 / dgp, 1.0)

        def pdot(a, b, own):
            return jax.lax.psum(jnp.sum(jnp.where(own, a * b, 0.0)),
                                AXIS)

        def block_cg(op, b, Minv, own):
            bb = pdot(b, b, own)
            tol2 = jnp.maximum(rtol, 1e-14) ** 2 * bb
            z = Minv * b
            rz = pdot(b, z, own)
            state = (jnp.zeros_like(b), b, z, z, rz, jnp.asarray(0))

            def cond(s):
                return (pdot(s[1], s[1], own) > tol2) & (s[5] < maxiter)

            def body(s):
                x, r, z, p, rz, k = s
                Ap = op(p)
                denom = pdot(p, Ap, own)
                alpha = jnp.where(denom != 0, rz / denom, 0.0)
                x = x + alpha * p
                r = r - alpha * Ap
                z = Minv * r
                rz_new = pdot(r, z, own)
                beta = jnp.where(rz != 0, rz_new / rz, 0.0)
                p = z + beta * p
                return x, r, z, p, rz_new, k + 1

            s = jax.lax.while_loop(cond, body, state)
            return s[0], pdot(s[1], s[1], own), s[5]

        bu = jnp.where(own_u, rhs_u, 0.0)
        bp = jnp.where(own_p, rhs_p, 0.0)
        zero_p = jnp.zeros_like(bp)
        zero_u = jnp.zeros_like(bu)
        du, rr_u, it_u = block_cg(
            lambda d: jv(d, zero_p)[0], bu, Minv_u, own_u)
        bp2 = bp - jv(du, zero_p)[1]
        dp, rr_p, it_p = block_cg(
            lambda d: jv(zero_u, d)[1], bp2, Minv_p, own_p)
        return du[None], dp[None], it_u + it_p, rr_u + rr_p

    return lambda u, phi, po, poo, sc, bu, bp, fu, fp, rtol: fn(
        u, phi, po, poo, part.arrays, sc, bu, bp, fu, fp, rtol)
