"""Multi-chip SPMD: domain decomposition of the element arrays over a
device mesh.

This replaces the reference's MPI + p4est partitioning + Trilinos
ghosted vectors (SURVEY.md section 2c/2d): the one parallelism axis of a
phase-field FEM code is *spatial* data parallelism over mesh cells.

Mapping (round 1 — replicated DoF vectors):
 * element arrays (gather maps, JxW, grads, material fields) are sharded
   along the cell axis (the LAST axis, per the layout convention in
   ops/physics.py) across the device mesh — cells are pre-sorted in
   space-filling-curve order per root, so contiguous shards are
   spatially compact (the analogue of a p4est partition);
 * solution vectors are replicated; the scatter-add of per-shard
   residuals is combined with a `psum` across devices — the analogue of
   Trilinos compress(VectorOperation::add) (cracks.cc:2470-2475);
 * scalar reductions (dot products in CG, norms) run on replicated
   vectors, so no further collectives are needed.

This is exact (bit-identical modulo reduction order) w.r.t. the
single-device path.  A halo-exchange variant with sharded DoF vectors
(ppermute between devices) is the planned next optimization for
>100M-DoF runs where replication no longer fits device memory.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import physics

# partition specs for CellArrays (cell axis LAST except gather maps,
# which are (stencil, n_c) -> also last)
_CA_SPEC = physics.CellArrays(
    gather_u=P(None, "cells"),
    gather_p=P(None, "cells"),
    JxW=P(None, "cells"),
    grads=P(None, None, None, "cells"),
    shape_v=P(),
    lam=P("cells"),
    mu=P("cells"),
    inv_diam2=P("cells"),
)


def make_device_mesh(n_devices: int | None = None,
                     dcn: int = 1) -> Mesh:
    """Device mesh for the cell-axis domain decomposition.

    dcn=1 (default): a flat ("cells",) mesh — every device reaches
    every other at the same rate (NVLink on one host), so the mesh
    follows the algorithm alone.  dcn>1: a host-major ("dcn", "cells")
    PRODUCT mesh for multi-host topologies: the cell axis is sharded
    over BOTH axes jointly (cell_axis()), so the partition is identical
    to the flat mesh — `jax.devices()` orders devices process-major, so
    contiguous Morton slabs land on devices within one host first — but
    XLA now knows which collective hops cross hosts and lowers
    reductions hierarchically (intra-host reduce, one inter-host
    exchange).  The slab-boundary halo rows exchanged by the lattice
    solve's shifted-window slices are then intra-host everywhere except
    at the dcn-1 host boundaries.  This is the same program multi-host
    JAX runs after jax.distributed.initialize(); the dcn axis is how the
    dry run validates that layout without multi-host hardware."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    if dcn > 1:
        if len(devs) % dcn:
            raise ValueError(
                f"dcn={dcn} does not divide n_devices={len(devs)}")
        return Mesh(np.array(devs).reshape(dcn, -1), ("dcn", "cells"))
    return Mesh(np.array(devs), ("cells",))


def cell_axis(mesh: Mesh):
    """Mesh axis name(s) spanning the cell dimension: "cells" on a
    flat mesh, ("dcn", "cells") jointly on a product mesh."""
    return (tuple(mesh.axis_names) if len(mesh.axis_names) > 1
            else "cells")


def ca_spec(mesh: Mesh) -> physics.CellArrays:
    """CellArrays PartitionSpecs with the cell axis mapped onto
    cell_axis(mesh)."""
    ax = cell_axis(mesh)
    if ax == "cells":
        return _CA_SPEC
    sub = lambda spec: P(*(ax if s == "cells" else s for s in spec))
    d = {k: (sub(v) if isinstance(v, P) else v)
         for k, v in _CA_SPEC._asdict().items()}
    return physics.CellArrays(**d)


def pad_cell_arrays(ca: physics.CellArrays, n_devices: int) -> physics.CellArrays:
    """Pad the cell axis to a multiple of n_devices with zero-weight
    dummy cells (JxW = 0 ⇒ zero contribution; gather indices point at
    dof 0, harmless)."""
    n_c = ca.gather_p.shape[-1]
    pad = (-n_c) % n_devices
    if pad == 0:
        return ca

    def padz(a, fill=0):
        widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
        return jnp.pad(a, widths, constant_values=fill)

    return physics.CellArrays(
        gather_u=padz(ca.gather_u),
        gather_p=padz(ca.gather_p),
        JxW=padz(ca.JxW),           # zero JxW kills the dummy cells
        grads=padz(ca.grads),
        shape_v=ca.shape_v,         # replicated table
        lam=padz(ca.lam, 1),
        mu=padz(ca.mu, 1),
        inv_diam2=padz(ca.inv_diam2, 1),
    )


def shard_cell_core(core: physics.CellCore, mesh: Mesh) -> physics.CellCore:
    """Shard the device-resident cell-FIRST geometry core along its
    leading cell axis (contiguous space-filling-curve blocks — the
    p4est partition).  The core is the largest per-epoch device-resident
    object; leaving it replicated adds an O(n_cells) per-chip floor.
    No-op when the cell count does not divide the device count (the
    derived CellArrays still get their own sharding downstream)."""
    n_c = int(core.JxW.shape[0])
    if n_c % mesh.devices.size:
        return core
    ns = NamedSharding(mesh, P(cell_axis(mesh)))
    put = lambda a: jax.device_put(a, ns)
    return physics.CellCore(
        gather_u=put(core.gather_u), gather_p=put(core.gather_p),
        JxW=put(core.JxW), grads=put(core.grads), lam=put(core.lam),
        mu=put(core.mu), inv_diam2=put(core.inv_diam2),
        shape_v=core.shape_v)


def shard_cell_arrays_nopad(ca: physics.CellArrays,
                            mesh: Mesh) -> physics.CellArrays:
    """Place the cell axis on the device mesh WITHOUT padding the cell
    count (uneven trailing shards are fine for GSPMD).  Used by the
    lattice fast path, whose (ndl, ndl, *cellgrid) reshape requires the
    exact raster cell count."""
    out = {}
    for name, spec in ca_spec(mesh)._asdict().items():
        arr = getattr(ca, name)
        if name == "chunked" or arr is None:
            out[name] = None if name == "chunked" else arr
            continue
        out[name] = jax.device_put(arr, NamedSharding(mesh, spec))
    return physics.CellArrays(**out)


def shard_cell_arrays(ca: physics.CellArrays, mesh: Mesh) -> physics.CellArrays:
    """Place each cell-axis leaf on the device mesh.

    The chunk-major scan duplicate (ca.chunked) is dropped: the SPMD
    path splits the cell axis across devices itself, so each shard is
    already bounded-size."""
    n_dev = mesh.devices.size
    spec = ca_spec(mesh)
    ca = pad_cell_arrays(ca._replace(chunked=None), n_dev)
    return physics.CellArrays(*(
        jax.device_put(arr, NamedSharding(mesh, s))
        for arr, s in zip(ca[:len(spec) - 1], spec[:len(spec) - 1])))


def sharded_residual_fn(mesh: Mesh, *, dim: int, with_split: bool,
                        monolithic: bool):
    """Build the SPMD residual: each shard assembles its cells' raw
    residual into a full-size vector; a psum across devices combines them."""

    ax = cell_axis(mesh)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), P(), ca_spec(mesh), P()),
             out_specs=(P(), P()))
    def fn(u, phi, phi_old, phi_oold, ca, sc):
        ru, rp = physics.assemble_residual(
            u, phi, phi_old, phi_oold, ca, sc,
            dim=dim, with_split=with_split, monolithic=monolithic)
        return (jax.lax.psum(ru, ax), jax.lax.psum(rp, ax))

    return fn


def sharded_jvp_fn(mesh: Mesh, *, dim: int, with_split: bool,
                   monolithic: bool):
    res_fn = sharded_residual_fn(mesh, dim=dim, with_split=with_split,
                                 monolithic=monolithic)

    def jv(u, phi, du, dphi, phi_old, phi_oold, ca, sc):
        f = lambda uu, pp: res_fn(uu, pp, phi_old, phi_oold, ca, sc)
        _, (dru, drp) = jax.jvp(f, (u, phi), (du, dphi))
        return -dru, -drp

    return jv


def make_multichip_newton_step(mesh: Mesh, con, hang_mask, diag_mass,
                               c_weight, *, dim: int, with_split: bool,
                               monolithic: bool, cg_iters: int = 30):
    """One full jitted PDAS Newton step with the element arrays sharded
    over the device mesh: sharded residual assembly (+psum across devices),
    on-device active-set update, and a block-triangular CG solve whose
    matrix-vector products run SPMD.

    Returns a jittable function
      step(u, phi, phi_old, phi_oold, ca_sharded, sc)
        -> (u_new, phi_new, residual_norm, n_active)
    """
    from ..ops.constraints import (condense_residual, expand_update,
                                   hanging_interpolate_p,
                                   hanging_transpose_p)

    res_fn = sharded_residual_fn(mesh, dim=dim, with_split=with_split,
                                 monolithic=monolithic)
    jv_fn = sharded_jvp_fn(mesh, dim=dim, with_split=with_split,
                           monolithic=monolithic)

    def cg(op, b, iters):
        x = jax.tree_util.tree_map(jnp.zeros_like, b)
        r = b
        p = r
        dot = lambda a, c: sum(jnp.vdot(q, w) for q, w in
                               zip(jax.tree_util.tree_leaves(a),
                                   jax.tree_util.tree_leaves(c)))
        rr = dot(r, r)

        def body(_, carry):
            x, r, p, rr = carry
            Ap = op(p)
            denom = dot(p, Ap)
            alpha = jnp.where(denom > 0, rr / denom, 0.0)
            x = jax.tree_util.tree_map(lambda a, q: a + alpha * q, x, p)
            r = jax.tree_util.tree_map(lambda a, q: a - alpha * q, r, Ap)
            rr_new = dot(r, r)
            beta = jnp.where(rr > 0, rr_new / rr, 0.0)
            p = jax.tree_util.tree_map(lambda a, q: a + beta * q, r, p)
            return x, r, p, rr_new

        x, r, p, rr = jax.lax.fori_loop(0, iters, body, (x, r, p, rr))
        return x

    def step(u, phi, phi_old, phi_oold, ca, sc):
        # residual + active-set indicator (cracks.cc:2822-2899)
        ru, rp = res_fn(u, phi, phi_old, phi_oold, ca, sc)
        tot_p = hanging_transpose_p(rp, con)
        indicator = tot_p / diag_mass + c_weight * (phi - phi_old)
        active = (indicator > 0.0) & ~hang_mask
        phi = jnp.where(active, phi_old, phi)
        phi = hanging_interpolate_p(phi, con)

        ru, rp = res_fn(u, phi, phi_old, phi_oold, ca, sc)
        rhs_u, rhs_p = condense_residual(ru, rp, con, active)

        def jvc(du, dp):
            eu, ep = expand_update(du, dp, con, active)
            ju, jp = jv_fn(u, phi, eu, ep, phi_old, phi_oold, ca, sc)
            return condense_residual(ju, jp, con, active)

        du = cg(lambda d: jvc(d, jnp.zeros_like(phi))[0], rhs_u, cg_iters)
        _, bp = jvc(du, jnp.zeros_like(phi))
        dp = cg(lambda d: jvc(jnp.zeros_like(u), d)[1], rhs_p - bp, cg_iters)
        du, dp = expand_update(du, dp, con, active)

        u = u + du
        phi = phi + dp
        ru, rp = res_fn(u, phi, phi_old, phi_oold, ca, sc)
        ru, rp = condense_residual(ru, rp, con, active)
        norm = jnp.sqrt(jnp.sum(ru * ru) + jnp.sum(rp * rp))
        return u, phi, norm, jnp.sum(active)

    return step
