"""Sharded-DoF primal-dual active set Newton for GENERAL meshes
(hanging nodes included) on the owned+ghost halo pool.

This is the counterpart of solvers/lattice_newton.py for the mesh
regimes the tensor-grid lattice cannot represent — locally pre-refined
production meshes (hetero 3d, parameters_hetero_3d.prm) and every
predictor-corrector adaptive epoch.  It implements the reference's
actual distributed design for those meshes: per-rank owned+ghost rows
(cracks.cc:1622-1628), ghosted reads before assembly (2147-2154),
compress(add) combines of partial residuals (2470-2475), and
distributed hanging-node constraints (2439-2464) — all expressed as
shard_map programs over parallel/halo.py's interface-pool primitive, so
the inter-chip traffic is the partition SURFACE (the pool), not the
volume.

State layout: every DoF vector is (D, n_loc) / (D, n_loc*dim), sharded
along the leading shard axis of the ("cells",) device mesh; slot order
per shard is [owned | ghost | trash].  Vectors are kept
OWNER-CANONICAL (ghost slots zero); every assembly refreshes ghosts
through the pool and applies the hanging interpolation H locally
(masters of local hanging vertices are guaranteed local by the
partition builder), and every result is H^T-distributed per shard and
owner-combined — the linearity of H^T and of the cell sums makes this
exactly the flat ops/constraints.py condensation.

The linear solve is the same block-lower-triangular split as the flat
path (u rows see no phi columns, cracks.cc:2353-2366): two SPD CGs on
the stored f64 element matrices with the pooled Galerkin GMG V-cycle
preconditioner when a hierarchy is available (solvers/halo_galerkin),
Jacobi otherwise.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import physics
from ..parallel import halo
from ..parallel.halo import AXIS, HaloPartition, halo_specs, _shard_ca
from .newton import NewtonLog, NoConvergence, _flips_within_band


# ---------------------------------------------------------------------------
# shard-local constraint primitives (composed with halo.make_halo_ops)
# ---------------------------------------------------------------------------

def make_hang_ops(part: HaloPartition):
    """Shard-level hanging interpolation H and distribution H^T in local
    slot indices (padded stencil rows target the trash slot with zero
    weights, so they only re-zero trash)."""
    n_loc, dim = part.n_loc, part.dim

    def hinterp(x, arr, comps):
        ch, ms, w = (arr.hang_child[0], arr.hang_masters[0],
                     arr.hang_weights[0])
        xm = x.reshape(n_loc, comps)
        vals = jnp.einsum("hm,hmc->hc", w.astype(x.dtype), xm[ms])
        return xm.at[ch].set(vals).reshape(x.shape)

    def htranspose(r, arr, comps):
        ch, ms, w = (arr.hang_child[0], arr.hang_masters[0],
                     arr.hang_weights[0])
        rm = r.reshape(n_loc, comps)
        vals = rm[ch]
        rm = rm.at[ms].add(w[..., None].astype(r.dtype)
                           * vals[:, None, :])
        rm = rm.at[ch].set(0.0)
        # padded stencil rows routed junk through the trash slot
        return rm.at[n_loc - 1].set(0.0).reshape(r.shape)

    hinterp_u = lambda x, arr: hinterp(x, arr, dim)
    hinterp_p = lambda x, arr: hinterp(x, arr, 1)
    htransp_u = lambda r, arr: htranspose(r, arr, dim)
    htransp_p = lambda r, arr: htranspose(r, arr, 1)
    return hinterp_u, hinterp_p, htransp_u, htransp_p


def _shard_primitives(part: HaloPartition):
    """All shard-level closures used by the fused heads."""
    gr_u, gr_p, cb_u, cb_p = halo.make_halo_ops(part)
    hi_u, hi_p, ht_u, ht_p = make_hang_ops(part)
    dim = part.dim

    def consistent(u, phi, phi_old, phi_oold, arr):
        """Owner-canonical -> assembly-ready: ghost refresh + H."""
        u = hi_u(gr_u(u, arr), arr)
        phi = hi_p(gr_p(phi, arr), arr)
        phi_old = hi_p(gr_p(phi_old, arr), arr)
        phi_oold = hi_p(gr_p(phi_oold, arr), arr)
        return u, phi, phi_old, phi_oold

    def condense(ru, rp, arr):
        """Partial raw residual -> condensed owner rows:
        per-shard H^T, owner combine (= H^T of the global sum)."""
        tu = cb_u(ht_u(ru, arr), arr)
        tp = cb_p(ht_p(rp, arr), arr)
        return tu, tp

    def free_masks(arr, dir_u, dir_p, active):
        own_u = jnp.repeat(arr.own_mask_p[0], dim)
        own_p = arr.own_mask_p[0]
        hang_u = jnp.repeat(arr.hang_mask[0], dim)
        free_u = own_u & ~dir_u & ~hang_u
        free_p = own_p & ~dir_p & ~arr.hang_mask[0] & ~active
        return free_u, free_p

    return dict(gr_u=gr_u, gr_p=gr_p, cb_u=cb_u, cb_p=cb_p,
                hi_u=hi_u, hi_p=hi_p, ht_u=ht_u, ht_p=ht_p,
                consistent=consistent, condense=condense,
                free_masks=free_masks)


# ---------------------------------------------------------------------------
# fused heads (one sharded dispatch each)
# ---------------------------------------------------------------------------

def build_halo_heads(mesh, part: HaloPartition, *, dim: int,
                     with_split: bool, max_steps: int):
    """The jitted shard_map programs of one PDAS solve: initial
    assembly, iteration head (set update + reassembly) and line search.
    `mesh` is the jax.sharding.Mesh."""
    pr = _shard_primitives(part)
    n_loc = part.n_loc

    def _residual(u, phi, phi_old, phi_oold, arr, sc):
        ca = _shard_ca(arr.ca)
        uc, pc, poc, pooc = pr["consistent"](u, phi, phi_old, phi_oold,
                                             arr)
        ru, rp = physics.assemble_residual(
            uc, pc, poc, pooc, ca, sc, dim=dim,
            with_split=with_split, monolithic=False)
        return pr["condense"](ru, rp, arr)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS),) * 6 + (halo_specs(), P()),
             out_specs=(P(AXIS), P(AXIS), P(AXIS), P()))
    def initial_assemble(u, phi, phi_old, phi_oold, dir_u, dir_p,
                         arr, sc):
        tu, tp = _residual(u[0], phi[0], phi_old[0], phi_oold[0], arr,
                           sc)
        active = jnp.zeros(n_loc, bool)
        free_u, free_p = pr["free_masks"](arr, dir_u[0], dir_p[0],
                                          active)
        pu = jnp.where(free_u, tu, 0.0)
        pp = jnp.where(free_p, tp, 0.0)
        res = jnp.sqrt(jax.lax.psum(
            jnp.sum(pu * pu) + jnp.sum(pp * pp), AXIS))
        return tp[None], pu[None], pp[None], res

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS),) * 10 + (P(), halo_specs(), P()),
             out_specs=(P(AXIS),) * 6 + (P(),) * 4 + (P(AXIS), P()))
    def head(u, phi, phi_old, phi_oold, tot_p, active_old, cycling,
             dir_u, dir_p, diag_mass, c_weight, arr, sc):
        """PDAS iteration head (cracks.cc:2822-2918): indicator on owned
        rows, set update, pinning, re-assembly, condensation,
        bookkeeping.  No re-assembly skip: hanging meshes disable it in
        the flat path too (newton._fused_active_set_update)."""
        (u, phi, phi_old, phi_oold, tot_p, active_old, cycling, dir_u,
         dir_p, diag_mass) = (x[0] for x in (
            u, phi, phi_old, phi_oold, tot_p, active_old, cycling,
            dir_u, dir_p, diag_mass))
        own_p = arr.own_mask_p[0]
        gap = phi - phi_old
        diag_safe = jnp.where(diag_mass > 0, diag_mass, 1.0)
        indicator = tot_p / diag_safe + c_weight * gap
        atol = 1e-12 * jnp.maximum(c_weight, sc.G_c / sc.alpha_eps)
        active = (((indicator > atol) | cycling) & ~arr.hang_mask[0]
                  & own_p)
        phi = jnp.where(active, phi_old, phi)
        tot_u, tot_p = _residual(u, phi, phi_old, phi_oold, arr, sc)
        free_u, free_p = pr["free_masks"](arr, dir_u, dir_p, active)
        pde_u = jnp.where(free_u, tot_u, 0.0)
        pde_p = jnp.where(free_p, tot_p, 0.0)
        n_active = jax.lax.psum(jnp.sum(active), AXIS)
        n_cycling = jax.lax.psum(jnp.sum(active & cycling), AXIS)
        flipped = (active != active_old) & own_p
        changed = jax.lax.psum(jnp.sum(flipped), AXIS)
        left = active_old & ~active
        ind_flip_max = jax.lax.pmax(
            jnp.max(jnp.where(flipped, jnp.abs(indicator), 0.0)), AXIS)
        ind_act_max = jax.lax.pmax(
            jnp.max(jnp.where(active, indicator, 0.0)), AXIS)
        return (u[None], phi[None], active[None], tot_p[None],
                pde_u[None], pde_p[None], n_active, n_cycling, changed,
                ind_flip_max, left[None], ind_act_max)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS),) * 9 + (P(), P(), halo_specs(), P()),
             out_specs=(P(AXIS),) * 5 + (P(), P()))
    def line_search(u, phi, du, dp, phi_old, phi_oold, active, dir_u,
                    dir_p, res0, damping, arr, sc):
        """Backtracking line search, one dispatch (cracks.cc:2940-2957);
        reference bookkeeping: a failed search restores the iterate but
        keeps the last trial's residual."""
        (u, phi, du, dp, phi_old, phi_oold, active, dir_u, dir_p) = (
            x[0] for x in (u, phi, du, dp, phi_old, phi_oold, active,
                           dir_u, dir_p))
        free_u, free_p = pr["free_masks"](arr, dir_u, dir_p, active)

        def trial(k):
            scale = damping ** k
            ut = u + du * scale
            pt = phi + dp * scale
            tu, tp = _residual(ut, pt, phi_old, phi_oold, arr, sc)
            pu = jnp.where(free_u, tu, 0.0)
            pp = jnp.where(free_p, tp, 0.0)
            res = jnp.sqrt(jax.lax.psum(
                jnp.sum(pu * pu) + jnp.sum(pp * pp), AXIS))
            return ut, pt, tp, pu, pp, res

        first = trial(jnp.asarray(0.0, u.dtype))

        def cond(s):
            k, accepted = s[0], s[1]
            return (~accepted) & (k < max_steps - 1)

        def body(s):
            k = s[0]
            out = trial((k + 1).astype(u.dtype))
            accepted = out[5] < res0
            return (k + 1, accepted) + out

        s0 = (jnp.asarray(0, jnp.int32), first[5] < res0) + first
        k, accepted, ut, pt, tot_p, pde_u, pde_p, res = \
            jax.lax.while_loop(cond, body, s0)
        u_out = jnp.where(accepted, ut, u)
        phi_out = jnp.where(accepted, pt, phi)
        return (u_out[None], phi_out[None], tot_p[None], pde_u[None],
                pde_p[None], res, k)

    # jitted whole: an eager shard_map dispatches (and compiles) every
    # primitive of its body one at a time
    return (jax.jit(initial_assemble), jax.jit(head),
            jax.jit(line_search))


def build_halo_cg(mesh, part: HaloPartition, *, dim: int,
                  with_split: bool, maxiter: int = 2000):
    """Block-lower-triangular split solve on the pool (the flat
    `_solve`'s structure, newton.py:45): stored f64 element matrices at
    the current iterate, two Jacobi-preconditioned SPD CGs (u block,
    then phi block with the J_pu du coupling moved to the rhs).  The
    matvec is local gather/einsum/scatter + H^T + owner combine —
    surface traffic only."""
    pr = _shard_primitives(part)
    nvc = 2 ** dim
    nud_l = nvc * dim

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS),) * 9 + (P(), halo_specs(), P()),
             out_specs=(P(AXIS), P(AXIS), P(), P()))
    def solve(u, phi, phi_old, phi_oold, active, dir_u, dir_p, rhs_u,
              rhs_p, rtol, arr, sc):
        (u, phi, phi_old, phi_oold, active, dir_u, dir_p, rhs_u,
         rhs_p) = (x[0] for x in (u, phi, phi_old, phi_oold, active,
                                  dir_u, dir_p, rhs_u, rhs_p))
        ca = _shard_ca(arr.ca)
        uc, pc, poc, pooc = pr["consistent"](u, phi, phi_old, phi_oold,
                                             arr)
        jac = physics.element_matrices(
            uc, pc, poc, pooc, ca, sc, dim=dim, with_split=with_split,
            monolithic=False, cell_last=True)
        free_u, free_p = pr["free_masks"](arr, dir_u, dir_p, active)

        def matvec(x, lo, hi, gather, comps, hi_fn, ht_fn, cb_fn, free):
            x = jnp.where(free, x, 0.0)
            xc = hi_fn(pr["gr_u"](x, arr) if comps == dim
                       else pr["gr_p"](x, arr), arr)
            xe = xc[gather]
            ye = jnp.einsum("ijc,jc->ic", jac[lo:hi, lo:hi], xe,
                            precision=jax.lax.Precision.HIGHEST)
            y = jnp.zeros_like(x).at[gather].add(ye)
            y = cb_fn(ht_fn(y, arr), arr)
            return jnp.where(free, y, 0.0)

        mv_u = lambda x: matvec(x, 0, nud_l, ca.gather_u, dim,
                                pr["hi_u"], pr["ht_u"], pr["cb_u"],
                                free_u)
        mv_p = lambda x: matvec(x, nud_l, nud_l + nvc, ca.gather_p, 1,
                                pr["hi_p"], pr["ht_p"], pr["cb_p"],
                                free_p)

        def coupling_pu(xu):
            """J_pu xu (phi rows, u columns) for the triangular rhs."""
            xc = pr["hi_u"](pr["gr_u"](jnp.where(free_u, xu, 0.0), arr),
                            arr)
            xe = xc[ca.gather_u]
            ye = jnp.einsum("ijc,jc->ic", jac[nud_l:nud_l + nvc, 0:nud_l],
                            xe, precision=jax.lax.Precision.HIGHEST)
            y = jnp.zeros(free_p.shape, xu.dtype).at[ca.gather_p].add(ye)
            y = pr["cb_p"](pr["ht_p"](y, arr), arr)
            return jnp.where(free_p, y, 0.0)

        # Jacobi diagonals of the condensed operator (raw diag combined;
        # hanging rows are excluded by the free masks)
        idx = jnp.arange(jac.shape[0])
        d_loc = jac[idx, idx, :]
        du_r = jnp.zeros(free_u.shape, jac.dtype).at[ca.gather_u].add(
            d_loc[:nud_l])
        dp_r = jnp.zeros(free_p.shape, jac.dtype).at[ca.gather_p].add(
            d_loc[nud_l:])
        du_r = pr["cb_u"](pr["ht_u"](du_r, arr), arr)
        dp_r = pr["cb_p"](pr["ht_p"](dp_r, arr), arr)
        Minv_u = jnp.where(free_u & (jnp.abs(du_r) > 0), 1.0 / du_r, 1.0)
        Minv_p = jnp.where(free_p & (jnp.abs(dp_r) > 0), 1.0 / dp_r, 1.0)

        def pdot(a, b):
            return jax.lax.psum(jnp.sum(a * b), AXIS)

        def block_cg(op, b, Minv):
            bb = pdot(b, b)
            tol2 = jnp.maximum(rtol, 1e-14) ** 2 * bb
            z = Minv * b
            rz = pdot(b, z)
            state = (jnp.zeros_like(b), b, z, z, rz, jnp.asarray(0))

            def cond(s):
                return (pdot(s[1], s[1]) > tol2) & (s[5] < maxiter)

            def body(s):
                x, r, z, p, rz, k = s
                Ap = op(p)
                denom = pdot(p, Ap)
                alpha = jnp.where(denom != 0, rz / denom, 0.0)
                x = x + alpha * p
                r = r - alpha * Ap
                z = Minv * r
                rz_new = pdot(r, z)
                beta = jnp.where(rz != 0, rz_new / rz, 0.0)
                p = z + beta * p
                return x, r, z, p, rz_new, k + 1

            s = jax.lax.while_loop(cond, body, state)
            return s[0], s[5]

        bu = jnp.where(free_u, rhs_u, 0.0)
        bp = jnp.where(free_p, rhs_p, 0.0)
        du, it_u = block_cg(mv_u, bu, Minv_u)
        bp2 = bp - coupling_pu(du)
        dp, it_p = block_cg(mv_p, bp2, Minv_p)
        return du[None], dp[None], it_u + it_p, pdot(bp2, bp2)

    return jax.jit(solve)


# ---------------------------------------------------------------------------
# the outer PDAS loop (host-orchestrated, mirrors lattice_newton)
# ---------------------------------------------------------------------------

def newton_active_set_halo(sys, state, time: float, verbose: bool = True):
    """Sharded-DoF PDAS Newton on the owned+ghost pool.  Same contract
    as newton.newton_active_set: mutates state.u/state.phi (flat at the
    boundary), returns the last residual reduction."""
    p = sys.params
    part: HaloPartition = sys.halo_partition
    mesh = sys._device_mesh
    dim = sys.dim
    with_split = sys.with_split
    log = NewtonLog()
    log.print_line("It.", "#A.Set", "#CycDoF", "Residual", "Reduction",
                   "LSrch", "#LinIts", verbose=verbose)

    heads = getattr(sys, "_halo_heads", None)
    if heads is None or heads[0] is not with_split:
        initial_assemble, head, line_search = build_halo_heads(
            mesh, part, dim=dim, with_split=with_split,
            max_steps=max(1, p.max_no_line_search_steps))
        solve = build_halo_solver(sys, mesh, part, dim=dim,
                                  with_split=with_split)
        sys._halo_heads = (with_split, initial_assemble, head,
                           line_search, solve)
    _, initial_assemble, head, line_search, solve = sys._halo_heads

    ns = NamedSharding(mesh, P(AXIS))
    place = lambda x: jax.device_put(jnp.asarray(x), ns)

    # boundary: flat state in, inhomogeneous BCs applied flat
    # (set_initial_bc, cracks.cc:2787), then scattered to the pool
    u_flat, phi_flat = sys.apply_initial_bc(state.u, state.phi, time)
    U = place(halo.global_to_local_u(part, np.asarray(u_flat)))
    Ph = place(halo.global_to_local_p(part, np.asarray(phi_flat)))
    P_old = place(halo.global_to_local_p(part, np.asarray(state.phi_old)))
    P_oold = place(halo.global_to_local_p(part,
                                          np.asarray(state.phi_oold)))
    con = sys._con
    dir_u = place(halo.global_to_local_u(
        part, np.asarray(con.dirichlet_u).astype(np.float64)) > 0.5)
    dir_p = place(halo.global_to_local_p(
        part, np.asarray(con.dirichlet_p).astype(np.float64)) > 0.5)
    diag_mass = place(halo.global_to_local_p(
        part, np.asarray(sys.diag_mass, np.float64)))
    sc = sys.scalars

    tot_p, pde_u, pde_p, res0_d = initial_assemble(
        U, Ph, P_old, P_oold, dir_u, dir_p, part.arrays, sc)
    newton_residual = float(res0_d)
    old_newton_residual = newton_residual
    log.print_line(0, "", "", f"{newton_residual:.6e}", verbose=verbose)

    active = place(np.zeros((part.n_shards, part.n_loc), bool))
    cycle_counter = np.zeros((part.n_shards, part.n_loc), np.int64)
    c_weight = 1e1 * p.E_modulus   # cracks.cc:2859
    n_cycling_threshold = 5        # cracks.cc:2866

    newton_step = 0
    sum_lin_it = 0
    new_newton_residual = 0.0
    while True:
        active_old = active
        cycling = place(cycle_counter >= n_cycling_threshold)
        (U, Ph, active, tot_p, pde_u, pde_p, n_active_d, n_cyc_d,
         changed_d, ind_flip_d, left_d, ind_act_d) = head(
            U, Ph, P_old, P_oold, tot_p, active_old, cycling, dir_u,
            dir_p, diag_mass, jnp.asarray(float(c_weight)),
            part.arrays, sc)
        (n_cyc_h, n_act_h, chg_h, left_h, ind_flip_h,
         ind_act_h) = jax.device_get(
            (n_cyc_d, n_active_d, changed_d, left_d, ind_flip_d,
             ind_act_d))
        n_cycling_dofs = int(n_cyc_h)
        n_active = int(n_act_h)
        num_changed = int(chg_h)
        ind_flip_max = float(ind_flip_h)
        ind_act_max = float(ind_act_h)
        cycle_counter[np.asarray(left_h)] += 1

        DU, DP, n_lin_d, _rr = solve(
            U, Ph, P_old, P_oold, active, dir_u, dir_p, pde_u, pde_p,
            jnp.asarray(p.cg_rtol), part.arrays, sc)
        n_lin = int(jax.device_get(n_lin_d))
        sum_lin_it += n_lin

        U, Ph, tot_p, pde_u, pde_p, res_d, ls_d = line_search(
            U, Ph, DU, DP, P_old, P_oold, active, dir_u, dir_p,
            jnp.asarray(newton_residual),
            jnp.asarray(p.line_search_damping), part.arrays, sc)
        res_h, ls_h = jax.device_get((res_d, ls_d))
        new_newton_residual = float(res_h)
        line_search_step = int(ls_h)

        log.print_line(
            newton_step + 1, n_active, n_cycling_dofs,
            f"{new_newton_residual:.6e}",
            f"{new_newton_residual / newton_residual:.6e}",
            line_search_step, n_lin, verbose=verbose)

        old_newton_residual = newton_residual
        newton_residual = new_newton_residual
        newton_step += 1

        set_settled = num_changed == 0
        if not set_settled:
            in_band, ind_band = _flips_within_band(
                newton_step, ind_flip_max, ind_act_max,
                p.active_set_rel_tol, c_weight,
                float(sc.G_c), float(sc.alpha_eps))
            if in_band:
                set_settled = True
                log.print_line(
                    f"\tActive set settled: {num_changed} flips within "
                    f"complementarity band {ind_band:.3e} "
                    f"(|ind|max {ind_flip_max:.3e})", verbose=verbose)
        if newton_residual < p.lower_bound_newton_residual and set_settled:
            log.print_line(f"\tNewton iterations: {newton_step} "
                           f"total linear iterations: {sum_lin_it}",
                           verbose=verbose)
            break
        if newton_step >= p.max_no_newton_steps:
            if verbose:
                print(f"Newton iteration did not converge in "
                      f"{newton_step} steps.")
            raise NoConvergence()

    # boundary: pooled state out -> flat driver state
    state.u = jnp.asarray(halo.local_to_global_u(part, np.asarray(U)))
    state.phi = jnp.asarray(halo.local_to_global_p(part,
                                                   np.asarray(Ph)))
    state.active_mask = halo.local_to_global_p(
        part, np.asarray(active).astype(np.float64)) > 0.5
    log.newton_steps = newton_step
    log.linear_iterations = sum_lin_it
    log.active_set_size = int(state.active_mask.sum())
    state.last_log = log
    return new_newton_residual / old_newton_residual


def build_halo_solver(sys, mesh, part, *, dim, with_split):
    """Linear-solver dispatch for the pooled path: the pooled Galerkin
    GMG split solve when the driver attached a pooled hierarchy, the
    Jacobi block CG otherwise."""
    hier = getattr(sys, "halo_galerkin_hierarchy", None)
    if hier is not None:
        from . import halo_galerkin
        return halo_galerkin.build_solver(sys, mesh, part, hier,
                                          dim=dim,
                                          with_split=with_split)
    return build_halo_cg(mesh, part, dim=dim, with_split=with_split)
