"""Tensor-grid monolattice solve path (solvers/lattice.py): layout
detection, lattice primitives vs their gather/scatter equivalents, and
the fused lattice solve vs the generic Galerkin solve."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cracks_tpu.solvers.lattice as lat
from cracks_tpu import meshio, problems
from cracks_tpu.config import Parameters
from cracks_tpu.mesh import Forest
from cracks_tpu.ops import physics


def _sneddon_sim(refine=3, precond="gmg"):
    from cracks_tpu.driver import Simulation
    p = Parameters(
        test_case="sneddon", pressure_expr="1.0e-3", G_c=1.0,
        poisson_ratio_nu=0.2, E_modulus=1.0, k_reg_expr="1e-8*h",
        eps_reg_expr="2.0*h", lower_bound_newton_residual=1e-7,
        max_no_newton_steps=50, max_no_line_search_steps=10,
        n_global_pre_refine=refine, n_local_pre_refine=0,
        n_refinement_cycles=0, max_no_timesteps=0, output_dir="",
        linear_solver="cg", preconditioner=precond, cg_rtol=1e-8,
        mixed_precision_cg=True)
    return Simulation(p, verbose=False)


def test_detect_tensor_grid():
    f = Forest(meshio.rect_mesh([-10, -10], [10, 10]))
    f.refine_global(2)
    mesh = f.extract()
    lay = lat.detect_tensor_grid(mesh)
    assert lay is not None
    assert lay.grid == (41, 41) and lay.seam is None
    # slit meshes (duplicated lip vertices) come back seam-glued
    import os
    from cracks_tpu.driver import MESH_DIR
    slit = meshio.read_ucd(os.path.join(MESH_DIR, "unit_slit.inp"), dim=2)
    fs = Forest(slit)
    fs.refine_global(2)
    lay_s = lat.detect_tensor_grid(fs.extract())
    assert lay_s is not None and lay_s.seam == lat.Seam(s=4, slit_lo=5)


def test_lattice_matvec_equals_assembled():
    f = Forest(meshio.rect_mesh([0, 0], [1, 1]))
    f.refine_global(2)
    mesh = f.extract()
    lay = lat.detect_tensor_grid(mesh)
    p = Parameters(test_case="sneddon", pressure_expr="1.0e-3",
                   G_c=1.0, poisson_ratio_nu=0.2, E_modulus=1.0)
    lam, mu = problems.cell_lame_fields(p, mesh, None)
    sc = physics.make_scalars(1e-3, 1e-8, 0.1, 1.0, 0.0, 1.0, 1.0, 0.0,
                              dtype=jnp.float32)
    caL = lat.permuted_cell_arrays(mesh, lam, mu, lay)
    ca = physics.build_cell_arrays(mesh, lam, mu, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    n_v = mesh.n_vertices
    u = jnp.asarray(rng.normal(size=n_v * 2), jnp.float32)
    phi = jnp.asarray(rng.uniform(0.2, 1.0, n_v), jnp.float32)
    kw = dict(dim=2, with_split=False, monolithic=False)
    jacL = physics.element_matrices(u, phi, phi, phi, caL, sc,
                                    cell_last=True, **kw)
    jacL = jacL.reshape((12, 12) + tuple(g - 1 for g in lay.grid))
    jac = physics.element_matrices(u, phi, phi, phi, ca, sc,
                                   cell_last=True, **kw)

    from cracks_tpu.solvers import assembled
    x = jnp.asarray(rng.normal(size=n_v * 2), jnp.float32)
    y_ref = assembled.matvec_uu(jac, ca, x, dim=2)
    X = lat._to_lat(x, jnp.asarray(lay.vert_pos), lay.grid, 2)
    Y = lat.matvec(jacL, X, 0, 8, 2)
    y = lat._to_glob(Y, jnp.asarray(lay.vert_pos), 2)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=2e-5, atol=2e-5)

    xp = jnp.asarray(rng.normal(size=n_v), jnp.float32)
    yp_ref = assembled.matvec_pp(jac, ca, xp, dim=2)
    Xp = lat._to_lat(xp, jnp.asarray(lay.vert_pos), lay.grid, 1)
    Yp = lat.matvec(jacL, Xp, 8, 12, 1)
    yp = lat._to_glob(Yp, jnp.asarray(lay.vert_pos), 1)
    np.testing.assert_allclose(np.asarray(yp), np.asarray(yp_ref),
                               rtol=2e-5, atol=2e-5)


def test_lattice_matvec_equals_assembled_3d():
    """3d octree-lattice matvec against the generic gather/scatter
    stored-matrix operator (reference treats 3d as first-class,
    cracks.cc:4648-4658)."""
    f = Forest(meshio.rect_mesh([0, 0, 0], [1, 1, 1], [1, 1, 1]))
    f.refine_global(2)
    mesh = f.extract()
    lay = lat.detect_tensor_grid(mesh)
    assert lay is not None and lay.grid == (5, 5, 5)
    p = Parameters(test_case="sneddon", pressure_expr="1.0e-3",
                   G_c=1.0, poisson_ratio_nu=0.2, E_modulus=1.0,
                   dimension=3)
    lam, mu = problems.cell_lame_fields(p, mesh, None)
    sc = physics.make_scalars(1e-3, 1e-8, 0.5, 1.0, 0.0, 1.0, 1.0, 0.0,
                              dtype=jnp.float32)
    caL = lat.permuted_cell_arrays(mesh, lam, mu, lay)
    ca = physics.build_cell_arrays(mesh, lam, mu, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    n_v = mesh.n_vertices
    u = jnp.asarray(rng.normal(size=n_v * 3), jnp.float32)
    phi = jnp.asarray(rng.uniform(0.2, 1.0, n_v), jnp.float32)
    kw = dict(dim=3, with_split=False, monolithic=False)
    jacL = physics.element_matrices(u, phi, phi, phi, caL, sc,
                                    cell_last=True, **kw)
    jacL = jacL.reshape((32, 32) + tuple(g - 1 for g in lay.grid))
    jac = physics.element_matrices(u, phi, phi, phi, ca, sc,
                                   cell_last=True, **kw)

    from cracks_tpu.solvers import assembled
    vp = jnp.asarray(lay.vert_pos)
    x = jnp.asarray(rng.normal(size=n_v * 3), jnp.float32)
    y_ref = assembled.matvec_uu(jac, ca, x, dim=3)
    Y = lat.matvec(jacL, lat._to_lat(x, vp, lay.grid, 3), 0, 24, 3)
    np.testing.assert_allclose(
        np.asarray(lat._to_glob(Y, vp, 3)), np.asarray(y_ref),
        rtol=2e-5, atol=2e-5)
    xp = jnp.asarray(rng.normal(size=n_v), jnp.float32)
    yp_ref = assembled.matvec_pp(jac, ca, xp, dim=3)
    Yp = lat.matvec(jacL, lat._to_lat(xp, vp, lay.grid, 1), 24, 32, 1)
    np.testing.assert_allclose(
        np.asarray(lat._to_glob(Yp, vp, 1)), np.asarray(yp_ref),
        rtol=2e-5, atol=2e-5)


def test_prolong_restrict_transpose():
    rng = np.random.default_rng(1)
    for grid_c, grid_f in (((9, 9), (17, 17)), ((5, 5, 5), (9, 9, 9))):
        for k in (1, 2):
            Xc = jnp.asarray(rng.normal(size=(k,) + grid_c))
            Yf = jnp.asarray(rng.normal(size=(k,) + grid_f))
            lhs = jnp.vdot(lat.prolong(Xc, grid_f, k), Yf)
            rhs = jnp.vdot(Xc, lat.restrict(Yf, k))
            assert float(abs(lhs - rhs)) < 1e-10 * float(abs(lhs) + 1)


def test_prolong_is_q1_embedding():
    """Prolongation must reproduce the exact multilinear interpolation
    of coarse nodal values (2d and 3d)."""
    rng = np.random.default_rng(2)
    for grid_c in ((5, 7), (3, 4, 5)):
        grid_f = tuple(2 * g - 1 for g in grid_c)
        dim = len(grid_c)
        Xc = rng.normal(size=(1,) + grid_c)
        Xf = np.asarray(lat.prolong(jnp.asarray(Xc), grid_f, 1))
        # even-index injection
        inj = Xf[(0,) + tuple(slice(None, None, 2) for _ in grid_c)]
        np.testing.assert_allclose(inj, Xc[0], atol=1e-14)
        # centers = mean of the 2^dim surrounding coarse nodes
        import itertools
        center = Xf[(0,) + tuple(slice(1, None, 2) for _ in grid_c)]
        acc = np.zeros_like(center)
        for o in itertools.product((0, 1), repeat=dim):
            sl = tuple(slice(o[j], grid_c[j] - 1 + o[j])
                       for j in range(dim))
            acc += Xc[(0,) + sl]
        np.testing.assert_allclose(center, acc / 2 ** dim, atol=1e-13)


def test_split_solve_matches_fused(monkeypatch):
    """The split-dispatch variant (bounded device executions for large
    problems) must reproduce the fused solve's statistics."""
    sim_f = _sneddon_sim()
    sim_f.run()
    assert sim_f.sys.lattice_hierarchy is not None
    monkeypatch.setattr(lat, "FUSED_SOLVE_MAX_DOFS", 0)
    sim_s = _sneddon_sim()
    sim_s.run()
    for colname in ("Bulk Energy", "Crack Energy"):
        a = sim_f.statistics.data[colname][-1]
        b = sim_s.statistics.data[colname][-1]
        assert b == pytest.approx(a, rel=1e-9), colname


def test_lattice_solve_matches_galerkin():
    """The fused lattice solve and the generic Galerkin fused solve are
    different implementations of the same algorithm; on one Sneddon
    load step they must produce the same statistics."""
    sim_l = _sneddon_sim()
    sim_l.run()
    assert sim_l.sys.lattice_hierarchy is not None
    bulk_l = sim_l.statistics.data["Bulk Energy"][-1]
    crack_l = sim_l.statistics.data["Crack Energy"][-1]

    sim_g = _sneddon_sim()
    # force the generic path by removing the lattice bundle
    import cracks_tpu.driver as drv
    orig = drv.Simulation.setup_system

    def patched(self):
        orig(self)
        self.sys.lattice_hierarchy = None
        self.sys.lattice_ca32 = None
        if self.sys.galerkin_hierarchy is None:
            from cracks_tpu.solvers import galerkin

            def dirichlet_fn(m):
                mu_, _, mp_, _ = problems.dirichlet_conditions(
                    self.p, m, 0.0, initial_step=False)
                return mu_, mp_
            self.sys.galerkin_hierarchy = galerkin.\
                build_galerkin_hierarchy(self.forest, self.mesh,
                                         dirichlet_fn)
    drv.Simulation.setup_system = patched
    try:
        sim_g = _sneddon_sim()
        sim_g.run()
        assert sim_g.sys.galerkin_hierarchy is not None
    finally:
        drv.Simulation.setup_system = orig
    bulk_g = sim_g.statistics.data["Bulk Energy"][-1]
    crack_g = sim_g.statistics.data["Crack Energy"][-1]
    assert bulk_l == pytest.approx(bulk_g, rel=1e-9)
    assert crack_l == pytest.approx(crack_g, rel=1e-9)


def test_iter_dist():
    """Staleness metric of the split-solve operator cache
    (lattice.py _iter_dist): zero for identical context, relative in u,
    absolute in the O(1)-scaled phase fields, relative in scalars."""
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.normal(size=16))
    phi = jnp.asarray(rng.uniform(0.2, 1.0, 8))
    sc = jnp.asarray([1.0, 2.0, 0.5])
    z = (u, phi, phi, phi, sc)
    assert float(lat._iter_dist(*z, *z)) == 0.0
    # relative displacement move
    d = float(lat._iter_dist(u * (1 + 1e-7), phi, phi, phi, sc, *z))
    assert d == pytest.approx(1e-7, rel=1e-2)
    # absolute phase-field move (phi has natural O(1) scale)
    d = float(lat._iter_dist(u, phi + 1e-4, phi, phi, sc, *z))
    assert d == pytest.approx(1e-4, rel=1e-6)
    # relative scalar move (e.g. the pressure ramp between time steps)
    sc2 = sc.at[0].set(1.0 + 1e-3)
    d = float(lat._iter_dist(u, phi, phi, phi, sc2, *z))
    assert d == pytest.approx(1e-3, rel=1e-6)


def test_split_solve_operator_reuse(monkeypatch):
    """Split-solve operators are reused while the Newton iterate stays
    within 1e-6 relative (the PDAS-tail regime) and rebuilt once it
    moves — and a reused-operator solve returns the identical update
    (lattice.py _solve_split cache; the reference's Jacobian-reuse idea,
    cracks.cc:3007)."""
    sim = _sneddon_sim(refine=3)
    state = sim.run()
    sys_ = sim.sys
    assert sys_.lattice_hierarchy is not None
    hier = sys_.lattice_hierarchy

    n_calls = {"prepare64": 0}
    orig_prepare64 = lat._prepare64

    def counting_prepare64(*a, **kw):
        n_calls["prepare64"] += 1
        return orig_prepare64(*a, **kw)

    monkeypatch.setattr(lat, "_prepare64", counting_prepare64)
    sys_._split_jac_cache = None  # start cold

    u, phi = state.u, state.phi
    phi_old, phi_oold = state.phi_old, state.phi_oold
    con = sys_.constraints(1.0)
    active = jnp.asarray(np.asarray(state.active_mask, dtype=bool))
    rng = np.random.default_rng(0)
    n_v = sim.mesh.n_vertices
    rhs_u = jnp.asarray(rng.normal(size=n_v * 2))
    rhs_p = jnp.asarray(rng.normal(size=n_v))

    du1, dp1, _ = lat._solve_split(sys_, hier, u, phi, phi_old,
                                   phi_oold, con, active, rhs_u, rhs_p,
                                   sys_.with_split)
    assert n_calls["prepare64"] == 1
    assert sys_._split_jac_cache is not None

    # same iterate -> cache hit, identical update
    du2, dp2, _ = lat._solve_split(sys_, hier, u, phi, phi_old,
                                   phi_oold, con, active, rhs_u, rhs_p,
                                   sys_.with_split)
    assert n_calls["prepare64"] == 1
    np.testing.assert_array_equal(np.asarray(du1), np.asarray(du2))
    np.testing.assert_array_equal(np.asarray(dp1), np.asarray(dp2))

    # tail-sized move (1e-8 << 1e-6) -> still a cache hit
    lat._solve_split(sys_, hier, u, phi + 1e-8, phi_old, phi_oold, con,
                     active, rhs_u, rhs_p, sys_.with_split)
    assert n_calls["prepare64"] == 1

    # real move (1e-3 > 1e-6) -> rebuild
    lat._solve_split(sys_, hier, u, phi + 1e-3, phi_old, phi_oold, con,
                     active, rhs_u, rhs_p, sys_.with_split)
    assert n_calls["prepare64"] == 2


def _dense_block(jacL, lo, hi, k, grid):
    """Dense f64 matrix of one lattice block, assembled cell by cell
    (comp-major global dofs d * n_vert + flat vertex, matching the
    (k, *grid) layout of lattice vectors)."""
    dim = len(grid)
    offs = lat._offsets(dim)
    nvert = int(np.prod(grid))
    J = np.asarray(jacL, np.float64)
    A = np.zeros((k * nvert, k * nvert))
    for c in np.ndindex(*(g - 1 for g in grid)):
        gdof = [d * nvert + int(np.ravel_multi_index(
                    tuple(ci + oi for ci, oi in zip(c, o)), grid))
                for o in offs for d in range(k)]
        A[np.ix_(gdof, gdof)] += J[(slice(lo, hi), slice(lo, hi)) + c]
    return A


@pytest.mark.parametrize("grid,which", [((5, 7), "u"), ((5, 7), "p"),
                                        ((4, 5, 6), "u"),
                                        ((4, 5, 6), "p")])
def test_matvec_matches_dense_f64(grid, which):
    """The XLA slice matvec (f32, Precision.HIGHEST) against a dense
    f64 matrix assembled from the same element matrices."""
    dim = len(grid)
    k, lo, hi = lat._blk(which, dim)
    ndl = 2 ** dim * (dim + 1)
    rng = np.random.default_rng(dim * 10 + k)
    jacL = jnp.asarray(rng.normal(size=(ndl, ndl) + tuple(
        g - 1 for g in grid)), jnp.float32)
    X = jnp.asarray(rng.normal(size=(k,) + grid), jnp.float32)
    y = np.asarray(jax.jit(lat.matvec, static_argnums=(2, 3, 4))(
        jacL, X, lo, hi, k), np.float64)
    y_ref = _dense_block(jacL, lo, hi, k, grid) @ np.asarray(
        X, np.float64).reshape(-1)
    err = np.linalg.norm(y.reshape(-1) - y_ref) / np.linalg.norm(y_ref)
    assert err <= 1e-6, err


@pytest.mark.parametrize("which", ["u", "p"])
def test_smoke_matvec_reference_matches_dense_f64(which):
    """chip_smoke.py's plain f64 stencil (the on-card reference of the
    matvec phase) against the dense f64 block on a non-square grid."""
    import importlib.util

    from .regression import REPO_ROOT
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", f"{REPO_ROOT}/chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    grid = (6, 9)
    k, lo, hi = lat._blk(which, 2)
    rng = np.random.default_rng(7 + k)
    jacL = jnp.asarray(rng.normal(size=(12, 12, 5, 8)), jnp.float32)
    X = jnp.asarray(rng.normal(size=(k,) + grid), jnp.float32)
    y = np.asarray(smoke._matvec_reference(jacL, X, lo, hi, k))
    y_ref = _dense_block(jacL, lo, hi, k, grid) @ np.asarray(
        X, np.float64).reshape(-1)
    np.testing.assert_allclose(y.reshape(-1), y_ref, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("grid", [(17, 9), (17, 5, 6)])
def test_sharded_matvec_matches_unsharded(grid):
    """The slice matvec on an 8-device row-slab layout (element
    matrices split along the leading cell axis, row-padded vectors
    split along the leading grid axis, as in the lattice-sharded
    solve) reproduces the single-device result."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cracks_tpu.parallel.sharding import make_device_mesh

    mesh = make_device_mesh(8)
    dim = len(grid)
    k, lo, hi = lat._blk("u", dim)
    ndl = 2 ** dim * (dim + 1)
    rng = np.random.default_rng(dim)
    jacL = jnp.asarray(rng.normal(size=(ndl, ndl) + tuple(
        g - 1 for g in grid)), jnp.float32)
    X = jnp.asarray(rng.normal(size=(k,) + grid), jnp.float32)
    gy = grid[0]
    gyp = -(-gy // 8) * 8
    spec_x = P(None, "cells", *([None] * (dim - 1)))
    ns_x = NamedSharding(mesh, spec_x)
    ns_j = NamedSharding(mesh, P(None, None, "cells",
                                 *([None] * (dim - 1))))

    @jax.jit
    def sharded(J, Xp):
        Y = lat.matvec(J, lat._unpad_rows(Xp, gy), lo, hi, k)
        return lat._pad_rows(Y, gyp, ns_x)

    Jd = jax.device_put(jacL, ns_j)
    Xd = jax.device_put(lat._pad_rows(X, gyp), ns_x)
    Y = sharded(Jd, Xd)
    assert len(Y.sharding.device_set) == 8
    assert {s.data.shape[1] for s in Y.addressable_shards} == {gyp // 8}
    y_ref = lat.matvec(jacL, X, lo, hi, k)
    np.testing.assert_allclose(np.asarray(Y)[:, :gy], np.asarray(y_ref),
                               rtol=1e-6, atol=1e-6)


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a jaxpr, recursively."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", v)
            if hasattr(sub, "eqns"):
                out += _dot_precisions(sub)
    return out


@pytest.mark.parametrize("op", ["matvec_block", "coarsen", "seam"])
def test_f32_contractions_at_highest_precision(op):
    """Every f32 contraction of the lattice solve chain asks for
    Precision.HIGHEST (a GPU may otherwise run it in TF32)."""
    from cracks_tpu.solvers.galerkin import embedding_matrices

    f32 = jnp.float32
    jac = jnp.ones((12, 12, 4, 4), f32)
    X = jnp.ones((2, 5, 5), f32)
    fns = {
        "matvec_block": lambda: lat.matvec_block(jac, X, 8, 12, 0, 8,
                                                 2, 1),
        "coarsen": lambda: lat.coarsen(
            jac, jnp.asarray(embedding_matrices(2), f32)),
        "seam": lambda: lat.seam_collect(
            lat.seam_spread(X, lat.Seam(s=2, slit_lo=1)),
            lat.Seam(s=2, slit_lo=1)),
    }
    precs = _dot_precisions(jax.make_jaxpr(fns[op])().jaxpr)
    assert precs, "no contraction traced"
    hi = jax.lax.Precision.HIGHEST
    assert all(p is not None and tuple(p) == (hi, hi) for p in precs), \
        precs
