"""Sharded-DoF primal-dual active set Newton: the PDAS loop of
newton.newton_active_set (cracks.cc:2780-2994) with every DoF vector in
LATTICE layout (k, *grid), sharded in contiguous slabs along the leading
grid axis over the device mesh.

This is the production sharded-DoF path demanded by the reference's
distributed design (owned+ghost rows per rank, cracks.cc:1622-1628,
2147-2154; compress(add) 2470-2475): no chip materializes the heavy
per-cell state whole, and the persistent DoF vectors are row-slab
sharded.  Assembly, active-set update, line search and the
split-dispatch GMG solve all run on the sharded lattice state; the
inter-chip traffic inside the step is the one-row window halo (GSPMD
collective-permute between devices — the p4est ghost-layer pattern, surface
not volume) plus scalar all-reduces for norms and dots.

Boundary representation: vertex-grid extents are odd, so every
boundary-crossing DoF vector is row-padded to gyp = ceil(GY/D)*D
(lattice._pad_rows; pad rows always zero) — the padded extent divides
the device count, making the slab NamedSharding representable.  Kernels
slice back to the true grid on entry (lattice._unpad_rows).

Selected by ``dof_sharding = lattice`` ("TPU parameters" /
"DoF sharding"); requires the tensor-grid lattice fast path (uniformly
refined rect/cube meshes, no hanging nodes) — exactly the regime where
replication stops fitting device memory.  Seam-glued slit lattices (the
unit_slit miehe family) are supported: every residual is conjugated
S^T . S through seam_spread/seam_collect, whose matmul form partitions
under GSPMD.  Flat global vectors appear only at the solver entry/exit
boundary (initial BCs in, driver state out).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import lattice
from .lattice import (_pad_rows, _unpad_rows, seam_collect, seam_spread)
from .newton import NewtonLog, NoConvergence, _flips_within_band


def _lat_residual_seam(U, P, P_old, P_oold, caL, sc, *, dim, with_split,
                       seam):
    """Canonical-form lattice residual: spread the seam so the window
    stencil sees both slit lips, collect the mirror contributions back
    (S^T r for the duplication map S; no-op for seam-free grids)."""
    sp = lambda X: seam_spread(X, seam)
    RU, RP = lattice.lattice_residual(
        sp(U), sp(P), sp(P_old), sp(P_oold), caL, sc, dim=dim,
        with_split=with_split, monolithic=False)
    return seam_collect(RU, seam), seam_collect(RP, seam)


@partial(jax.jit, static_argnames=("grid", "dim", "with_split",
                                   "can_skip", "gyp", "ns", "seam"))
def _fused_active_set_update_lat(U, P, P_old, P_oold, tot_p, pde_u_in,
                                 pde_p_in, resid_ok, active_old, cycling,
                                 dir_u, dir_p, diag_mass, c_weight, caL,
                                 sc, *, grid, dim, with_split, can_skip,
                                 gyp, ns=None, seam=None):
    """Lattice-layout PDAS iteration head (one dispatch): indicator,
    set update, pinning, re-assembly, condensation and the bookkeeping
    scalars (cracks.cc:2822-2918).  Same logic as newton.
    _fused_active_set_update with the hanging-node machinery dropped
    (the lattice path requires a hanging-free mesh) and the gather-free
    lattice residual.  All (k, gyp, ...) vector args arrive row-padded;
    outputs are re-padded and slab-constrained."""
    gy = grid[0]
    up = lambda x: _unpad_rows(x, gy)
    U, P, P_old, P_oold = up(U), up(P), up(P_old), up(P_oold)
    tot_p, pde_u_in, pde_p_in = up(tot_p), up(pde_u_in), up(pde_p_in)
    active_old, cycling = up(active_old), up(cycling)
    dir_u, dir_p, diag_mass = up(dir_u), up(dir_p), up(diag_mass)

    gap = P - P_old
    # seam lattices carry zero-mass dead/mirror slots inside the true
    # grid; guard the divide so no NaN enters the bookkeeping maxima
    diag_safe = jnp.where(diag_mass > 0, diag_mass, 1.0)
    indicator = tot_p / diag_safe + c_weight * gap
    # absolute indicator floor against f64-emulation noise — identical
    # to the flat head (see newton._fused_active_set_update)
    atol = 1e-12 * jnp.maximum(c_weight, sc.G_c / sc.alpha_eps)
    active = (indicator > atol) | cycling
    P = jnp.where(active, P_old, P)

    def reassemble(_):
        RU, RP = _lat_residual_seam(U, P, P_old, P_oold, caL, sc,
                                    dim=dim, with_split=with_split,
                                    seam=seam)
        pu = jnp.where(dir_u, 0.0, RU)
        pp = jnp.where(dir_p | active, 0.0, RP)
        return RP, pu, pp

    if can_skip:
        unchanged = jnp.all(active == active_old) & resid_ok
        tot_p, pde_u, pde_p = jax.lax.cond(
            unchanged, lambda _: (tot_p, pde_u_in, pde_p_in),
            reassemble, None)
    else:
        tot_p, pde_u, pde_p = reassemble(None)
    n_active = jnp.sum(active)
    n_cycling = jnp.sum(active & cycling)
    flipped = active != active_old
    changed = jnp.sum(flipped)
    left = active_old & ~active
    ind_flip_max = jnp.max(jnp.where(flipped, jnp.abs(indicator), 0.0))
    ind_act_max = jnp.max(jnp.where(active, indicator, 0.0))
    pad = lambda x: _pad_rows(x, gyp, ns)
    return (pad(U), pad(P), pad(active), pad(tot_p), pad(pde_u),
            pad(pde_p), n_active, n_cycling, changed, pad(left),
            ind_flip_max, ind_act_max)


@partial(jax.jit, static_argnames=("grid", "dim", "with_split",
                                   "max_steps", "gyp", "ns", "seam"))
def _fused_line_search_lat(U, P, DU, DP, P_old, P_oold, active, dir_u,
                           dir_p, caL, sc, res0, damping, *, grid, dim,
                           with_split, max_steps, gyp, ns=None,
                           seam=None):
    """Lattice-layout backtracking line search, one dispatch
    (cracks.cc:2940-2957); bookkeeping identical to newton.
    _fused_line_search (failed search restores the iterate but keeps the
    last trial's residual).  Padded boundary convention as above."""
    gy = grid[0]
    up = lambda x: _unpad_rows(x, gy)
    U, P, DU, DP = up(U), up(P), up(DU), up(DP)
    P_old, P_oold, active = up(P_old), up(P_oold), up(active)
    dir_u, dir_p = up(dir_u), up(dir_p)

    def trial(k):
        scale = damping ** k
        Ut = U + DU * scale
        Pt = P + DP * scale
        RU, RP = _lat_residual_seam(Ut, Pt, P_old, P_oold, caL, sc,
                                    dim=dim, with_split=with_split,
                                    seam=seam)
        pu = jnp.where(dir_u, 0.0, RU)
        pp = jnp.where(dir_p | active, 0.0, RP)
        res = jnp.sqrt(jnp.sum(pu * pu) + jnp.sum(pp * pp))
        return Ut, Pt, RP, pu, pp, res

    first = trial(jnp.asarray(0.0, U.dtype))

    def cond(s):
        k, accepted = s[0], s[1]
        return (~accepted) & (k < max_steps - 1)

    def body(s):
        k = s[0]
        out = trial((k + 1).astype(U.dtype))
        accepted = out[5] < res0
        return (k + 1, accepted) + out

    s0 = (jnp.asarray(0, jnp.int32), first[5] < res0) + first
    k, accepted, Ut, Pt, tot_p, pde_u, pde_p, res = \
        jax.lax.while_loop(cond, body, s0)
    U_out = jnp.where(accepted, Ut, U)
    P_out = jnp.where(accepted, Pt, P)
    pad = lambda x: _pad_rows(x, gyp, ns)
    return (pad(U_out), pad(P_out), pad(tot_p), pad(pde_u), pad(pde_p),
            res, k)


@partial(jax.jit, static_argnames=("grid", "dim", "with_split", "gyp",
                                   "ns", "seam"))
def _initial_assemble_lat(U, P, P_old, P_oold, active, dir_u, dir_p,
                          caL, sc, *, grid, dim, with_split, gyp,
                          ns=None, seam=None):
    """Initial residual assembly + condensation (cracks.cc:2790-2791),
    padded lattice layout, one dispatch."""
    gy = grid[0]
    up = lambda x: _unpad_rows(x, gy)
    RU, RP = _lat_residual_seam(
        up(U), up(P), up(P_old), up(P_oold), caL, sc, dim=dim,
        with_split=with_split, seam=seam)
    pu = jnp.where(up(dir_u), 0.0, RU)
    pp = jnp.where(up(dir_p) | up(active), 0.0, RP)
    res = jnp.sqrt(jnp.sum(pu * pu) + jnp.sum(pp * pp))
    pad = lambda x: _pad_rows(x, gyp, ns)
    return pad(RP), pad(pu), pad(pp), res


def newton_active_set_lattice(sys, state, time: float,
                              verbose: bool = True):
    """Sharded-DoF PDAS Newton on lattice-layout state.  Same contract
    as newton.newton_active_set: mutates state.u/state.phi (flat, at the
    boundary), returns the last residual reduction."""
    p = sys.params
    hier: lattice.LatticeHierarchy = sys.lattice_hierarchy
    assert hier is not None, "lattice DoF sharding requires the lattice path"
    grid = hier.grid
    dim = sys.dim
    vert_pos = hier.vert_pos
    gyp = sys.lat_gyp
    ns = sys.lat_ns()
    log = NewtonLog()
    log.print_line("It.", "#A.Set", "#CycDoF", "Residual", "Reduction",
                   "LSrch", "#LinIts", verbose=verbose)

    with_split = sys.with_split

    def place(X):
        Xp = _pad_rows(X, gyp)
        return Xp if ns is None else jax.device_put(Xp, ns)

    # boundary: flat state in, inhomogeneous BCs applied flat
    # (set_initial_bc, cracks.cc:2787), then lifted to the sharded
    # padded lattice layout
    u, phi = sys.apply_initial_bc(state.u, state.phi, time)
    U = place(lattice._to_lat(u, vert_pos, grid, dim))
    P = place(lattice._to_lat(phi, vert_pos, grid, 1))
    P_old = place(lattice._to_lat(state.phi_old, vert_pos, grid, 1))
    P_oold = place(lattice._to_lat(state.phi_oold, vert_pos, grid, 1))
    # diag_mass pad rows are zero, but the head slices back to the true
    # grid before dividing, so no pad entry is ever divided into a NaN
    diag_mass = place(lattice._to_lat(
        jnp.asarray(sys.diag_mass, jnp.float64), vert_pos, grid, 1))
    dir_u = place(jnp.asarray(hier.dir_u[-1]))
    dir_p = place(jnp.asarray(hier.dir_p[-1]))
    caL = sys.lattice_ca64

    seam = hier.seam
    active = place(jnp.zeros((1,) + grid, dtype=bool))
    tot_p, pde_u, pde_p, res0_d = _initial_assemble_lat(
        U, P, P_old, P_oold, active, dir_u, dir_p, caL, sys.scalars,
        grid=grid, dim=dim, with_split=with_split, gyp=gyp, ns=ns,
        seam=seam)
    newton_residual = float(res0_d)
    old_newton_residual = newton_residual
    log.print_line(0, "", "", f"{newton_residual:.6e}", verbose=verbose)

    cycle_counter = np.zeros((1, gyp) + grid[1:], dtype=np.int64)
    c_weight = 1e1 * p.E_modulus   # cracks.cc:2859
    n_cycling_threshold = 5        # cracks.cc:2866
    resid_ok = True

    newton_step = 0
    sum_lin_it = 0
    new_newton_residual = 0.0
    while True:
        active_old = active
        cycling = jnp.asarray(cycle_counter >= n_cycling_threshold)
        if ns is not None:
            cycling = jax.device_put(cycling, ns)
        (U, P, active, tot_p, pde_u, pde_p, n_active_d, n_cyc_d,
         changed_d, left_d, ind_flip_d, ind_act_d) = \
            _fused_active_set_update_lat(
                U, P, P_old, P_oold, tot_p, pde_u, pde_p,
                jnp.asarray(resid_ok), active_old, cycling, dir_u,
                dir_p, diag_mass, c_weight, caL, sys.scalars,
                grid=grid, dim=dim, with_split=with_split,
                can_skip=True, gyp=gyp, ns=ns, seam=seam)
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

        # ---- sharded split-dispatch solve (cracks.cc:2919) ----
        DU, DP, n_lin = lattice._solve_split_lat(
            sys, hier, U, P, P_old, P_oold, active, pde_u, pde_p,
            with_split)
        # distribute (homogeneous constraints: zero Dirichlet + active;
        # pad rows of dir masks are False and DU/DP pad rows zero)
        DU = jnp.where(dir_u, 0.0, DU)
        DP = jnp.where(dir_p | active, 0.0, DP)
        sum_lin_it += n_lin

        U, P, tot_p, pde_u, pde_p, res_d, ls_d = _fused_line_search_lat(
            U, P, DU, DP, P_old, P_oold, active, dir_u, dir_p, caL,
            sys.scalars, jnp.asarray(newton_residual),
            p.line_search_damping, grid=grid, dim=dim,
            with_split=with_split,
            max_steps=max(1, p.max_no_line_search_steps), gyp=gyp,
            ns=ns, seam=seam)
        res_h, ls_h = jax.device_get((res_d, ls_d))
        new_newton_residual = float(res_h)
        line_search_step = int(ls_h)
        resid_ok = new_newton_residual < newton_residual

        log.print_line(
            newton_step + 1, n_active, n_cycling_dofs,
            f"{new_newton_residual:.6e}",
            f"{new_newton_residual / newton_residual:.6e}",
            line_search_step, n_lin, verbose=verbose)

        old_newton_residual = newton_residual
        newton_residual = new_newton_residual
        newton_step += 1

        # convergence: residual below bound AND set settled (exact
        # fixity, or flips inside the complementarity band — see
        # newton.newton_active_set)
        set_settled = num_changed == 0
        if not set_settled:
            in_band, ind_band = _flips_within_band(
                newton_step, ind_flip_max, ind_act_max,
                p.active_set_rel_tol, c_weight,
                float(sys.scalars.G_c), float(sys.scalars.alpha_eps))
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

    # boundary: sharded lattice state out -> flat driver state
    gy = grid[0]
    state.u = lattice._to_glob(_unpad_rows(U, gy), vert_pos, dim)
    state.phi = lattice._to_glob(_unpad_rows(P, gy), vert_pos, 1)
    state.active_mask = np.asarray(lattice._to_glob(
        _unpad_rows(active, gy).astype(jnp.float64), vert_pos, 1) > 0.5)
    log.newton_steps = newton_step
    log.linear_iterations = sum_lin_it
    log.active_set_size = int(state.active_mask.sum())
    state.last_log = log
    return new_newton_residual / old_newton_residual
