"""Nonlinear solvers: primal-dual active set semismooth Newton and the
penalized monolithic Newton iteration.

Faithful reimplementations of the reference's newton_active_set
(cracks.cc:2780-2994) and newton_iteration (cracks.cc:2997-3107) as
host-side control flow around jitted device kernels.  The active set is
a boolean mask over phase-field vertices; "constraint lines" become
mask entries; all convergence logic, cycle detection and line search
follow the reference step for step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import jax.numpy as jnp
import numpy as np

from ..ops import physics
from ..ops.constraints import (Constraints, condense_residual,
                               hanging_interpolate_p, hanging_interpolate_u,
                               hanging_transpose_p, hanging_transpose_u,
                               residual_linfty, residual_norm)
from . import linear


class NoConvergence(Exception):
    """Raised when Newton fails; the driver catches it and cuts the time
    step (cracks.cc:4333-4336, 4397-4400)."""


@dataclass
class NewtonLog:
    newton_steps: int = 0
    linear_iterations: int = 0
    active_set_size: int = 0
    lines: list = field(default_factory=list)

    def print_line(self, *cols, verbose=True):
        line = "\t".join(str(c) for c in cols)
        self.lines.append(line)
        if verbose:
            print(line)


def _solve(sys, u, phi, phi_old, phi_oold, con, active, rhs_u, rhs_p,
           with_split):
    """Dispatch to the configured linear solver. Returns (du, dp, iters).

    'auto' uses the exact sparse factorization for small systems and the
    matrix-free CG for large ones.  Configurations with K reg = 0 can
    make the displacement block exactly singular inside a fully
    developed crack (pf_extra == 0); the reference handles those with an
    iterative Krylov solver whose iterates stay in the range space
    (GMRES, cracks.cc:2762-2771), so a singular factorization falls back
    to the CG path, which has the same property."""
    p = sys.params
    mode = p.linear_solver
    if mode == "auto":
        mode = ("direct"
                if sys.mesh.n_dofs <= linear.DENSE_DIRECT_MAX_DOFS
                else "cg")
    if mode == "direct":
        try:
            return linear.solve_direct(
                u, phi, phi_old, phi_oold, sys.ca, sys.scalars, con, active,
                rhs_u, rhs_p, dim=sys.dim, with_split=with_split,
                monolithic=sys.monolithic)
        except RuntimeError:
            pass  # exactly singular factor -> CG below
    if (p.assembled_matvec
            and getattr(sys, "mixed_precision", False)
            and getattr(sys, "lattice_hierarchy", None) is not None):
        # tensor-grid monolattice fused solve: gather-free Krylov loop
        # (solvers/lattice.py)
        from . import lattice
        from ..ops.constraints import expand_update
        du, dp, its = lattice.solve_lattice(
            sys, u, phi, phi_old, phi_oold, con, active, rhs_u, rhs_p,
            with_split)
        du, dp = expand_update(du, dp, con, active)
        return du, dp, its
    if (p.assembled_matvec
            and getattr(sys, "galerkin_hierarchy", None) is not None):
        return _solve_assembled(sys, u, phi, phi_old, phi_oold, con,
                                active, rhs_u, rhs_p, with_split)
    if getattr(sys, "hierarchy", None) is not None:
        du, dp, iters = linear.solve_cg_gmg(
            u, phi, phi_old, phi_oold, sys.ca, sys.scalars, con, active,
            rhs_u, rhs_p, sys.hierarchy, p.cg_rtol, 1e-300,
            dim=sys.dim, with_split=with_split, monolithic=sys.monolithic,
            maxiter=p.cg_maxiter)
        return du, dp, int(iters)
    if p.assembled_matvec:
        return _solve_assembled(sys, u, phi, phi_old, phi_oold, con,
                                active, rhs_u, rhs_p, with_split)
    kw = dict(dim=sys.dim, with_split=with_split, monolithic=sys.monolithic)
    total_its = 0
    du = dp = None
    bnorm0 = float(jnp.sqrt(jnp.vdot(rhs_u, rhs_u).real
                            + jnp.vdot(rhs_p, rhs_p).real))
    if getattr(sys, "mixed_precision", False):
        # mixed precision via iterative refinement: a capped f32 Krylov
        # pass takes the cheap iterations; the f64 correction solve below
        # finishes to the requested tolerance (f32 CG stagnates at its
        # kappa*eps floor once the rhs gets small late in Newton)
        f32 = lambda x: jnp.asarray(x, dtype=jnp.float32)
        from ..ops.constraints import Constraints as _C
        con32 = _C(*(f32(v) if v.dtype == jnp.float64 else v for v in con))
        sc32 = physics.Scalars(*(f32(v) for v in sys.scalars))
        args32 = (f32(u), f32(phi), f32(phi_old), f32(phi_oold))
        diag_u, diag_p = physics.jacobi_diagonal_approx(
            *args32, sys.ca32, sc32, dim=sys.dim, monolithic=sys.monolithic)
        du32, dp32, it32 = linear.solve_cg_block_chunked(
            *args32, sys.ca32, sc32, con32, active,
            f32(rhs_u), f32(rhs_p), diag_u, diag_p,
            max(p.cg_rtol, 1e-4), 1e-300,
            maxiter=min(p.cg_maxiter, 10 * p.cg_chunk), chunk=p.cg_chunk,
            **kw)
        total_its += int(it32)
        du = jnp.asarray(du32, dtype=u.dtype)
        dp = jnp.asarray(dp32, dtype=u.dtype)
        # f64 correction residual
        ju, jp = physics.jacobian_vector_product(
            u, phi, du, dp, phi_old, phi_oold, sys.ca, sys.scalars, **kw)
        from ..ops.constraints import condense_residual as _cond
        ju, jp = _cond(ju, jp, con, active)
        rhs_u = rhs_u - ju
        rhs_p = rhs_p - jp

    diag_u, diag_p = physics.jacobi_diagonal_approx(
        u, phi, phi_old, phi_oold, sys.ca, sys.scalars,
        dim=sys.dim, monolithic=sys.monolithic)
    # correction (or full) solve in f64: tolerance relative to the
    # ORIGINAL right-hand side when refining
    # when refining, the correction only needs to reach cg_rtol relative
    # to the ORIGINAL right-hand side
    atol = max(p.cg_rtol * bnorm0, 1e-300) if du is not None else 1e-300
    cu, cp, it64 = linear.solve_cg_block_chunked(
        u, phi, phi_old, phi_oold, sys.ca, sys.scalars, con, active,
        rhs_u, rhs_p, diag_u, diag_p, p.cg_rtol, atol,
        maxiter=p.cg_maxiter, chunk=p.cg_chunk, **kw)
    total_its += int(it64)
    if du is None:
        du, dp = cu, cp
    else:
        du = du + cu
        dp = dp + cp
    return du, dp, total_its


def _solve_assembled(sys, u, phi, phi_old, phi_oold, con, active,
                     rhs_u, rhs_p, with_split):
    """Stored-element-matrix solve (solvers/assembled.py): the element
    Jacobians are built once per Newton iteration, every Krylov
    iteration is a batched dense matvec.  Mixed precision follows the
    iterative-refinement scheme: capped f32 Krylov pass, f64 correction
    solve to the requested tolerance (relative to the original rhs)."""
    from . import assembled
    from ..ops.constraints import Constraints as _C, expand_update
    p = sys.params
    kw = dict(dim=sys.dim, with_split=with_split, monolithic=sys.monolithic)
    n_ud, n_v = u.shape[0], phi.shape[0]
    total_its = 0
    du = dp = None
    bnorm0 = float(jnp.sqrt(jnp.vdot(rhs_u, rhs_u).real
                            + jnp.vdot(rhs_p, rhs_p).real))
    ghier = getattr(sys, "galerkin_hierarchy", None)

    def krylov(jac_, ca_, con_, active_, bu, bp, rtol, atol, maxiter):
        if ghier is not None:
            from . import galerkin
            return galerkin.solve_cg_block(
                ghier, jac_, ca_, con_, active_, bu, bp, rtol, atol,
                dim=sys.dim, maxiter=maxiter, chunk=p.cg_chunk)
        d_u, d_p = assembled.diagonals(jac_, ca_, n_ud, n_v, dim=sys.dim)
        return assembled.solve_cg_block(
            jac_, ca_, con_, active_, bu, bp, d_u, d_p, rtol, atol,
            dim=sys.dim, maxiter=maxiter, chunk=p.cg_chunk)

    if getattr(sys, "mixed_precision", False) and ghier is not None:
        from . import galerkin, lattice
        if sys.mesh.n_dofs > lattice.FUSED_SOLVE_MAX_DOFS:
            # above the split-dispatch threshold: host-orchestrated
            # restarted refinement, same algorithm
            du, dp, its = galerkin.solve_split(
                sys, ghier, u, phi, phi_old, phi_oold, con, active,
                rhs_u, rhs_p, with_split)
            du, dp = expand_update(du, dp, con, active)
            return du, dp, its
        # ONE device dispatch for the whole solve: f64 element-Jacobian
        # build, f32 Galerkin V-cycle preconditioner, f64 CG with
        # restarted refinement passes (galerkin.solve_newton_system);
        # at small sizes the solve is dispatch-latency bound.
        #
        # Operator reuse across the PDAS tail (production sizes only,
        # gated by the same sharp_spectrum policy that marks the
        # production regime): the f32 RAP chain + u-block spectra are
        # active-set independent, and the f64 operator is re-linearized
        # fresh each call, so a <= 1e-6-stale chain changes only
        # preconditioner quality, never the solution beyond tolerance.
        # Golden-size solves keep reuse OFF so their digit-level
        # statistics parity is untouched.
        from .lattice import _iter_dist, _scalars_vec
        from .multigrid import sharp_spectrum
        import os as _os
        reuse = None
        sc_vec = None
        _r = _os.environ.get("CRACKS_TPU_REUSE", "auto")
        cache_on = (_r == "1" if _r in ("0", "1")
                    else sharp_spectrum(sys.mesh.n_dofs))
        if cache_on:
            sc_vec = _scalars_vec(sys.scalars)
            cache = getattr(sys, "_fused_cache_g", None)
            if cache is not None:
                key0, flags0, reuse_c = cache
                if (flags0 == (with_split, sys.monolithic)
                    and all(a.shape == b.shape for a, b in
                            zip(key0, (u, phi, phi_old, phi_oold,
                                       sc_vec)))):
                    d = float(_iter_dist(u, phi, phi_old, phi_oold,
                                         sc_vec, *key0))
                    if d <= float(_os.environ.get(
                            "CRACKS_TPU_JAC_RTOL", "1e-6")):
                        reuse = reuse_c
                if reuse is None:
                    sys._fused_cache_g = None
        du, dp, its, _rr, reuse_out = galerkin.solve_newton_system(
            u, phi, phi_old, phi_oold, sys.ca, sys.scalars,
            ghier.levels, ghier.P_embed, con, active, rhs_u, rhs_p,
            p.cg_rtol, reuse, dim=sys.dim, with_split=with_split,
            monolithic=sys.monolithic)
        if cache_on:
            sys._fused_cache_g = ((u, phi, phi_old, phi_oold, sc_vec),
                                  (with_split, sys.monolithic),
                                  reuse_out)
        total_its += int(its)
        du, dp = expand_update(du, dp, con, active)
        return du, dp, total_its

    if getattr(sys, "mixed_precision", False):
        f32 = lambda x: jnp.asarray(x, dtype=jnp.float32)
        con32 = _C(*(f32(v) if v.dtype == jnp.float64 else v for v in con))
        sc32 = physics.Scalars(*(f32(v) for v in sys.scalars))
        args32 = (f32(u), f32(phi), f32(phi_old), f32(phi_oold))
        jac32 = assembled.build_jacobians(*args32, sys.ca32, sc32, **kw)
        jac = assembled.build_jacobians(u, phi, phi_old, phi_oold,
                                        sys.ca, sys.scalars, **kw)
        # Jacobi mode: iterative refinement — f32 Krylov passes, f64
        # stored-matrix residual updates between passes; a stalling
        # pass falls back to a f64 Jacobi-CG finish.
        target = max(p.cg_rtol * bnorm0, 1e-300)
        du = jnp.zeros_like(u)
        dp = jnp.zeros_like(phi)
        ru, rp = rhs_u, rhs_p
        rnorm = bnorm0
        for _ in range(8):
            cu32, cp32, its = krylov(
                jac32, sys.ca32, con32, active, f32(ru), f32(rp),
                max(p.cg_rtol, 1e-4), 1e-300,
                min(p.cg_maxiter, 4 * p.cg_chunk))
            total_its += int(its)
            du_try = du + jnp.asarray(cu32, dtype=u.dtype)
            dp_try = dp + jnp.asarray(cp32, dtype=u.dtype)
            ru2, rp2 = assembled.residual_update(
                jac, sys.ca, con, active, du_try, dp_try, rhs_u, rhs_p,
                dim=sys.dim)
            rnorm2 = float(jnp.sqrt(jnp.vdot(ru2, ru2).real
                                    + jnp.vdot(rp2, rp2).real))
            if np.isfinite(rnorm2) and rnorm2 < 0.2 * rnorm:
                # accept the f32 correction
                du, dp, ru, rp, rnorm = du_try, dp_try, ru2, rp2, rnorm2
                if rnorm <= target:
                    break
                continue
            # f32 floor, or overflow garbage on a noise-level rhs (this
            # happens when Newton continues past the f64 residual floor
            # because the active set still changes): discard the
            # unaccepted correction and finish in f64 Jacobi-CG.
            d_u, d_p = assembled.diagonals(jac, sys.ca, n_ud, n_v,
                                           dim=sys.dim)
            cu, cp, it64 = assembled.solve_cg_block(
                jac, sys.ca, con, active, ru, rp, d_u, d_p,
                p.cg_rtol, target, dim=sys.dim,
                maxiter=p.cg_maxiter, chunk=p.cg_chunk)
            total_its += int(it64)
            du = du + cu
            dp = dp + cp
            break
        du, dp = expand_update(du, dp, con, active)
        return du, dp, total_its

    jac = assembled.build_jacobians(u, phi, phi_old, phi_oold, sys.ca,
                                    sys.scalars, **kw)
    du, dp, its = krylov(jac, sys.ca, con, active, rhs_u, rhs_p,
                         p.cg_rtol, 1e-300, p.cg_maxiter)
    total_its += int(its)
    du, dp = expand_update(du, dp, con, active)
    return du, dp, total_its


from functools import partial

import jax


@partial(jax.jit, static_argnames=("dim", "with_split", "can_skip"))
def _fused_active_set_update(u, phi, phi_old, phi_oold, tot_p, pde_u_in,
                             pde_p_in, resid_ok, active_old, cycling,
                             hang_mask, diag_mass, c_weight, ca, sc, con,
                             *, dim, with_split, can_skip):
    """One dispatch for the whole PDAS iteration head: indicator, set
    update, pinning, hanging distribution, re-assembly, condensation and
    the bookkeeping scalars (cracks.cc:2822-2918).

    With can_skip=True (hanging-node-free meshes only) an unchanged
    active set skips the f64 re-assembly via lax.cond and returns the
    residuals already in hand: the Newton update is zero on constrained
    dofs (constraints.expand_update), so when no dof changed status the
    pinning is a no-op and the incoming (tot_p, pde) — assembled at
    exactly this (u, phi) by the line search (or the initial assemble)
    — ARE this head's residuals, bit for bit.  `resid_ok` guards the
    one case where they are not: a fully failed line search restores
    (u, phi) but leaves the LAST TRIAL's residual in hand (matching the
    reference's member-variable bookkeeping), so the skip is suppressed
    and the head re-assembles at the restored iterate exactly like the
    reference does.  On meshes with hanging nodes the re-interpolation
    is not bit-exactly idempotent against the update's distribute, so
    the skip is disabled."""
    gap = phi - phi_old
    indicator = tot_p / diag_mass + c_weight * gap
    # The reference tests `indicator > 0` (cracks.cc:2865) and relies on
    # the bulk residual being EXACTLY zero away from the crack.  A
    # different f64 summation order leaves ~1e-18 noise there, which
    # would activate
    # tens of thousands of bulk dofs on the sign of rounding error; the
    # tiny absolute floor is far below any genuine activation (those are
    # O(stress) ~ O(G_c/eps)) and far above arithmetic noise.  The floor
    # scales with the problem's own stress scales (c_weight = 10 E and
    # the crack driving force G_c/eps) so strongly nondimensionalized
    # configurations (E << 1) keep a proportionally small floor.
    atol = 1e-12 * jnp.maximum(c_weight, sc.G_c / sc.alpha_eps)
    active = ((indicator > atol) | cycling) & ~hang_mask
    phi = jnp.where(active, phi_old, phi)
    phi = hanging_interpolate_p(phi, con)
    u = hanging_interpolate_u(u, con)

    def reassemble(_):
        ru, rp = physics.assemble_residual(
            u, phi, phi_old, phi_oold, ca, sc,
            dim=dim, with_split=with_split, monolithic=False)
        tp = hanging_transpose_p(rp, con)
        pu, pp = condense_residual(ru, rp, con, active)
        return tp, pu, pp

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
    # complementarity diagnostics: the largest |indicator| among the
    # dofs that changed status this iteration, and the constraint-force
    # scale (largest indicator over the active set).  A flip whose
    # indicator magnitude is far below the force scale is a marginal
    # dof whose pinned/free status is beneath the linear-solve
    # tolerance — see the convergence test in newton_active_set.
    ind_flip_max = jnp.max(jnp.where(flipped, jnp.abs(indicator), 0.0))
    ind_act_max = jnp.max(jnp.where(active, indicator, 0.0))
    return (u, phi, active, tot_p, pde_u, pde_p,
            n_active, n_cycling, changed, left,
            ind_flip_max, ind_act_max)


@partial(jax.jit, static_argnames=("dim", "with_split", "max_steps"))
def _fused_line_search(u, phi, du, dp, phi_old, phi_oold, active, ca, sc,
                       con, res0, damping, *, dim, with_split,
                       max_steps):
    """The WHOLE backtracking line search in one dispatch
    (cracks.cc:2940-2957): trial k steps by du * damping^k; accept the
    first trial whose residual decreases.  Mirrors the reference's
    bookkeeping exactly — on total failure the solution is restored but
    the assembled residual (tot_p/pde) remains the last trial's (the
    reference leaves the member residual from the final assemble).

    Fusing the trials matters in the PDAS tail: iterations at the
    residual floor can burn all max_steps trials, each a full f64
    element sweep — one dispatch instead of max_steps host round
    trips."""
    def trial(k):
        scale = damping ** k
        ut = u + du * scale
        pt = phi + dp * scale
        ru, rp = physics.assemble_residual(
            ut, pt, phi_old, phi_oold, ca, sc,
            dim=dim, with_split=with_split, monolithic=False)
        tot_p = hanging_transpose_p(rp, con)
        pde_u, pde_p = condense_residual(ru, rp, con, active)
        return ut, pt, tot_p, pde_u, pde_p, residual_norm(pde_u, pde_p)

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
    return u_out, phi_out, tot_p, pde_u, pde_p, res, k


@partial(jax.jit, static_argnames=("dim", "with_split"))
def _ls_trial(u, phi, du, dp, phi_old, phi_oold, active, ca, sc, con,
              damping, k, *, dim, with_split):
    """One backtracking trial (single bounded dispatch) — the body of
    _fused_line_search, identical arithmetic (scale = damping ** k
    computed ON DEVICE so the iterates match the fused variant
    bit-for-bit)."""
    scale = damping ** k
    ut = u + du * scale
    pt = phi + dp * scale
    ru, rp = physics.assemble_residual(
        ut, pt, phi_old, phi_oold, ca, sc,
        dim=dim, with_split=with_split, monolithic=False)
    tot_p = hanging_transpose_p(rp, con)
    pde_u, pde_p = condense_residual(ru, rp, con, active)
    return ut, pt, tot_p, pde_u, pde_p, residual_norm(pde_u, pde_p)


def _line_search_split(u, phi, du, dp, phi_old, phi_oold, active, ca,
                       sc, con, res0, damping, *, dim, with_split,
                       max_steps):
    """Host-orchestrated backtracking line search: one bounded device
    dispatch per trial.  Bit-identical decisions to _fused_line_search
    (same trial arithmetic, same acceptance compare) — used above the
    split-dispatch threshold (lattice.FUSED_SOLVE_MAX_DOFS)."""
    res0_h = float(res0)
    damp_d = jnp.asarray(damping, u.dtype)
    k = 0
    out = _ls_trial(u, phi, du, dp, phi_old, phi_oold, active, ca, sc,
                    con, damp_d, jnp.asarray(0.0, u.dtype), dim=dim,
                    with_split=with_split)
    accepted = float(out[5]) < res0_h
    while not accepted and k < max_steps - 1:
        k += 1
        out = _ls_trial(u, phi, du, dp, phi_old, phi_oold, active, ca,
                        sc, con, damp_d, jnp.asarray(float(k), u.dtype),
                        dim=dim, with_split=with_split)
        accepted = float(out[5]) < res0_h
    ut, pt, tot_p, pde_u, pde_p, res = out
    u_out = ut if accepted else u
    phi_out = pt if accepted else phi
    return (u_out, phi_out, tot_p, pde_u, pde_p, res,
            jnp.asarray(k, jnp.int32))


def _flips_within_band(newton_step, ind_flip_max, ind_act_max,
                       active_set_rel_tol, c_weight, G_c, alpha_eps):
    """Marginal-dof complementarity band of the PDAS convergence test.

    Returns (in_band, band): whether every status flip this iteration
    has |indicator| within `active_set_rel_tol` of zero relative to the
    constraint-force scale `ind_act_max` (such a dof satisfies discrete
    complementarity in either status — see the narrative at the call
    site), plus the band value for logging.  Never fires before the
    second Newton iteration (the first set update is the real one), and
    keeps an absolute floor of 10x the indicator noise floor so a
    zero-force active set (ind_act_max == 0) cannot produce a zero-width
    band that rejects pure-noise flips."""
    if newton_step < 2:
        return False, 0.0
    atol_ind = 1e-12 * max(c_weight, G_c / max(alpha_eps, 1e-300))
    ind_band = max(active_set_rel_tol * ind_act_max, 1e1 * atol_ind)
    return ind_flip_max <= ind_band, ind_band


def newton_active_set(sys, state, time: float, verbose: bool = True):
    """Primal-dual active set Newton (cracks.cc:2780-2994).

    `sys` is a driver.System (mesh epoch bundle); `state` is the driver's
    SolutionState with fields u, phi (current) and u_old, phi_old,
    phi_oold (previous time steps), all jnp arrays.

    Mutates state.u/state.phi; returns the last residual reduction.
    """
    p = sys.params
    log = NewtonLog()
    log.print_line("It.", "#A.Set", "#CycDoF", "Residual", "Reduction",
                   "LSrch", "#LinIts", verbose=verbose)

    con = sys.constraints(time)
    with_split = sys.with_split

    # set_initial_bc + hanging distribute (cracks.cc:2787-2788)
    u, phi = sys.apply_initial_bc(state.u, state.phi, time)
    u = hanging_interpolate_u(u, con)
    phi = hanging_interpolate_p(phi, con)

    def assemble(u_, phi_, active_):
        ru, rp = physics.assemble_residual(
            u_, phi_, state.phi_old, state.phi_oold, sys.ca, sys.scalars,
            dim=sys.dim, with_split=with_split, monolithic=False)
        tot_p = hanging_transpose_p(rp, con)
        pde_u, pde_p = condense_residual(ru, rp, con, active_)
        return tot_p, (pde_u, pde_p)

    n_v = sys.mesh.n_vertices
    active = jnp.zeros(n_v, dtype=bool)
    tot_p, (pde_u, pde_p) = assemble(u, phi, active)
    newton_residual = float(residual_norm(pde_u, pde_p))
    old_newton_residual = newton_residual
    log.print_line(0, "", "", f"{newton_residual:.6e}", verbose=verbose)

    import os
    import time as _wt
    debug_as = os.environ.get("CRACKS_TPU_DEBUG_AS") == "1"
    debug_t = os.environ.get("CRACKS_TPU_DEBUG_SOLVE") == "1"

    def _tick(label, x):
        """Wall-clock print of one phase in debug mode."""
        if debug_t:
            t0 = _wt.perf_counter()
            jax.block_until_ready(x)
            print(f"#     [{label}: {_wt.perf_counter() - t0:6.2f}s]",
                  flush=True)
        return x

    cycle_counter = np.zeros(n_v, dtype=np.int64)
    hang_mask = jnp.asarray(sys.mesh.hanging_mask())
    diag_mass = sys.diag_mass  # jnp (n_v,)
    c_weight = 1e1 * p.E_modulus  # cracks.cc:2859
    n_cycling_threshold = 5       # cracks.cc:2866

    # re-assembly skip (see _fused_active_set_update): only on
    # hanging-node-free meshes, and only while the residuals in hand
    # were assembled at the current iterate (True for the initial
    # assemble; False after a fully failed line search).
    can_skip = int(con.hang_child_p.shape[0]) == 0
    resid_ok = True

    newton_step = 0
    sum_lin_it = 0
    new_newton_residual = 0.0
    while True:
        active_old = active

        # ---- active set update + re-assembly, one dispatch
        #      (cracks.cc:2822-2918) ----
        cycling = jnp.asarray(cycle_counter >= n_cycling_threshold)
        (u, phi, active, tot_p, pde_u, pde_p, n_active_d, n_cyc_d,
         changed_d, left_d, ind_flip_d, ind_act_d) = _tick(
            "as_update", _fused_active_set_update(
                u, phi, state.phi_old, state.phi_oold, tot_p, pde_u,
                pde_p, jnp.asarray(resid_ok), active_old,
                cycling, hang_mask, diag_mass, c_weight, sys.ca,
                sys.scalars, con, dim=sys.dim, with_split=with_split,
                can_skip=can_skip))
        # one bulk transfer for all host-needed scalars (each separate
        # int()/np.asarray is a device round trip)
        (n_cyc_h, n_act_h, chg_h, left_h, ind_flip_h,
         ind_act_h) = jax.device_get(
            (n_cyc_d, n_active_d, changed_d, left_d, ind_flip_d,
             ind_act_d))
        n_cycling_dofs = int(n_cyc_h)
        n_active = int(n_act_h)
        num_changed = int(chg_h)
        ind_flip_max = float(ind_flip_h)
        ind_act_max = float(ind_act_h)
        if debug_as:
            n_flip = int(np.sum(np.asarray(active != active_old)))
            print(f"#   AS: flips={n_flip} |ind_flip|max="
                  f"{ind_flip_max:.3e} ind_act_max={ind_act_max:.3e}",
                  flush=True)
        # cycle detection: count dofs that LEFT the set (cracks.cc:2901-2907)
        cycle_counter[left_h] += 1

        # ---- solve (cracks.cc:2919) ----
        t_solve = _wt.perf_counter()
        du, dp, n_lin = _solve(sys, u, phi, state.phi_old, state.phi_oold,
                               con, active, pde_u, pde_p, with_split)
        if debug_t:
            jax.block_until_ready(du)
            print(f"#     [solve: {_wt.perf_counter() - t_solve:6.2f}s "
                  f"({n_lin} its)]", flush=True)
        sum_lin_it += n_lin

        # ---- line search (cracks.cc:2940-2957): one dispatch for all
        # trials at golden sizes; one dispatch PER trial above the
        # split-dispatch threshold (identical decisions) ----
        from .lattice import FUSED_SOLVE_MAX_DOFS as _FMAX
        _ls = (_line_search_split if sys.mesh.n_dofs > _FMAX
               else _fused_line_search)
        u, phi, tot_p, pde_u, pde_p, res_d, ls_d = _tick(
            "line_search", _ls(
                u, phi, du, dp, state.phi_old, state.phi_oold, active,
                sys.ca, sys.scalars, con,
                jnp.asarray(newton_residual), p.line_search_damping,
                dim=sys.dim, with_split=with_split,
                max_steps=max(1, p.max_no_line_search_steps)))
        res_h, ls_h = jax.device_get((res_d, ls_d))
        new_newton_residual = float(res_h)
        line_search_step = int(ls_h)
        # acceptance criterion mirrors the line search's own (< res0);
        # a fully failed search leaves the last trial's residual in
        # hand, assembled away from the restored iterate
        resid_ok = new_newton_residual < newton_residual

        log.print_line(
            newton_step + 1, n_active, n_cycling_dofs,
            f"{new_newton_residual:.6e}",
            f"{new_newton_residual / newton_residual:.6e}",
            line_search_step, n_lin, verbose=verbose)

        old_newton_residual = newton_residual
        newton_residual = new_newton_residual
        newton_step += 1

        # Convergence (cracks.cc:2971-2973): residual below the bound
        # AND the active set settled.  The reference demands EXACT set
        # fixity (its active_set_tolarance constant is 0.0,
        # cracks.cc:2860), which works at test sizes where the discrete
        # constraint-force spectrum has gaps much wider than solver
        # noise.  At 1M+ DoFs the force spectrum near zero is quasi-
        # continuous and the iteration "peels" marginal dofs forever:
        # measured at 1.23M DoFs (Sneddon 2d refine 6, step 1), ~100
        # dofs/iteration flip with indicator magnitudes ~1e-8 RELATIVE
        # to the active-set force scale, decaying only ~0.68x per
        # iteration — dozens of iterations at residual 1e-12 (bound
        # 1e-7) with no physical change.  A dof whose |indicator| is
        # within `active_set_rel_tol` of zero (relative to the largest
        # active constraint force) satisfies the complementarity
        # conditions to that tolerance in either status, so a flip
        # inside that band is not a meaningful set change.  Exact
        # fixity still short-circuits first whenever it happens (all
        # reference-size runs), keeping golden parity bit-identical.
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
                print(f"Newton iteration did not converge in {newton_step} steps.")
            raise NoConvergence()

    state.u = u
    state.phi = phi
    state.active_mask = np.asarray(active)
    log.newton_steps = newton_step
    log.linear_iterations = sum_lin_it
    log.active_set_size = int(state.active_mask.sum())
    state.last_log = log
    return new_newton_residual / old_newton_residual


def newton_iteration(sys, state, time: float, verbose: bool = True):
    """Penalized monolithic Newton with Jacobian reuse
    (cracks.cc:2997-3107)."""
    p = sys.params
    log = NewtonLog()
    log.print_line("It.", "Residual", "Reduction", "LSrch", "#LinIts",
                   verbose=verbose)
    nonlinear_rho = 0.1  # cracks.cc:3007

    con = sys.constraints(time)
    with_split = sys.with_split
    active = jnp.zeros(sys.mesh.n_vertices, dtype=bool)

    u, phi = sys.apply_initial_bc(state.u, state.phi, time)

    def assemble(u_, phi_):
        ru, rp = physics.assemble_residual(
            u_, phi_, state.phi_old, state.phi_oold, sys.ca, sys.scalars,
            dim=sys.dim, with_split=with_split, monolithic=True)
        return condense_residual(ru, rp, con, active)

    pde_u, pde_p = assemble(u, phi)
    newton_residual = float(residual_linfty(pde_u, pde_p))
    old_newton_residual = newton_residual
    newton_step = 1
    log.print_line(0, f"{newton_residual:.6e}", verbose=verbose)

    # linearization point for Jacobian reuse
    u_lin, phi_lin = u, phi

    while (newton_residual > p.lower_bound_newton_residual
           and newton_step < p.max_no_newton_steps):
        old_newton_residual = newton_residual
        pde_u, pde_p = assemble(u, phi)
        newton_residual = float(residual_linfty(pde_u, pde_p))
        if newton_residual < p.lower_bound_newton_residual:
            log.print_line("", f"{newton_residual:.6e}", verbose=verbose)
            break

        rebuild = (newton_step == 1
                   or newton_residual / old_newton_residual > nonlinear_rho)
        if rebuild:
            u_lin, phi_lin = u, phi

        du, dp, n_lin = _solve(sys, u_lin, phi_lin, state.phi_old,
                               state.phi_oold, con, active, pde_u, pde_p,
                               with_split)
        log.linear_iterations += n_lin

        line_search_step = 0
        new_newton_residual = newton_residual
        for line_search_step in range(p.max_no_line_search_steps):
            u = u + du
            phi = phi + dp
            pde_u, pde_p = assemble(u, phi)
            new_newton_residual = float(residual_linfty(pde_u, pde_p))
            if new_newton_residual < newton_residual:
                break
            u = u - du
            phi = phi - dp
            du = du * p.line_search_damping
            dp = dp * p.line_search_damping

        old_newton_residual = newton_residual
        newton_residual = new_newton_residual
        log.print_line(newton_step, f"{newton_residual:.6e}",
                       f"{newton_residual / old_newton_residual:.6e}",
                       line_search_step, n_lin, verbose=verbose)

        if (newton_residual / old_newton_residual > p.upper_newton_rho
                and newton_step > 1):
            break
        newton_step += 1

    if (newton_residual > p.lower_bound_newton_residual
            and newton_step == p.max_no_newton_steps):
        if verbose:
            print(f"Newton iteration did not converge in {newton_step} steps :-(")
        raise NoConvergence()

    state.u = u
    state.phi = phi
    log.newton_steps = newton_step
    state.last_log = log
    return newton_residual / old_newton_residual
