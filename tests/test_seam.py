"""Seam-glued slit lattice (solvers/lattice.py Seam): detection on the
reference's `unit_slit.inp` family (cracks.cc:1202-1205), the S^T A S
operator conjugation, the slab-aware GMG transfer pair, the Galerkin
coarsening identity, and end-to-end solver-path parity on a miehe
shear load step."""

import numpy as np
import jax.numpy as jnp
import pytest

import cracks_tpu.solvers.lattice as lat
from cracks_tpu import meshio, problems
from cracks_tpu.config import Parameters
from cracks_tpu.mesh import Forest
from cracks_tpu.ops import physics


def _slit_mesh(refine=3):
    import os
    from cracks_tpu.driver import MESH_DIR
    m = meshio.read_ucd(os.path.join(MESH_DIR, "unit_slit.inp"), dim=2)
    f = Forest(m)
    f.refine_global(refine)
    return f.extract()


def _slit_context(refine=3, with_split=False, dtype=jnp.float64):
    """(mesh, lay, jacL, jac_generic, ca, vert_pos) on the slit mesh
    with a random smooth state."""
    mesh = _slit_mesh(refine)
    lay = lat.detect_tensor_grid(mesh)
    assert lay is not None and lay.seam is not None
    p = Parameters(test_case="miehe shear", pressure_expr="0.0",
                   G_c=2.7, poisson_ratio_nu=0.3, E_modulus=1.0)
    lam, mu = problems.cell_lame_fields(p, mesh, None)
    sc = physics.make_scalars(0.0, 1e-8, 0.05, 2.7, 0.0, 1.0, 1.0, 0.0,
                              dtype=dtype)
    caL = lat.permuted_cell_arrays(mesh, lam, mu, lay, dtype=dtype)
    ca = physics.build_cell_arrays(mesh, lam, mu, dtype=dtype)
    rng = np.random.default_rng(0)
    n_v = mesh.n_vertices
    u = jnp.asarray(1e-3 * rng.normal(size=n_v * 2), dtype)
    phi = jnp.asarray(rng.uniform(0.3, 1.0, n_v), dtype)
    kw = dict(dim=2, with_split=with_split, monolithic=False)
    ndl = 12
    jacL = physics.element_matrices(u, phi, phi, phi, caL, sc,
                                    cell_last=True, **kw)
    jacL = jacL.reshape((ndl, ndl) + tuple(g - 1 for g in lay.grid))
    jac = physics.element_matrices(u, phi, phi, phi, ca, sc,
                                   cell_last=True, **kw)
    return mesh, lay, jacL, jac, ca


def test_detect_slit_grid_structure():
    mesh = _slit_mesh(3)
    lay = lat.detect_tensor_grid(mesh)
    assert lay is not None
    seam = lay.seam
    assert seam is not None
    # one extra vertex row, dead cell raster row between the lips
    assert lay.grid == (18, 17)
    assert seam == lat.Seam(s=8, slit_lo=9)
    dead = lay.cell_perm.reshape(17, 16) < 0
    assert dead[seam.s].all() and dead.sum() == 16
    # every vertex has a unique lattice slot; mirror glued slots empty
    assert len(np.unique(lay.vert_pos)) == mesh.n_vertices
    vi = lay.vert_idx
    assert (vi[seam.s + 1, :seam.slit_lo] < 0).all()
    assert (vi[seam.s + 1, seam.slit_lo:] >= 0).all()
    # duplicated lips: same geometric point, different DoFs
    lo_ids = vi[seam.s, seam.slit_lo:]
    up_ids = vi[seam.s + 1, seam.slit_lo:]
    np.testing.assert_allclose(mesh.vert_coords[lo_ids],
                               mesh.vert_coords[up_ids])
    assert (lo_ids != up_ids).all()


def test_seam_spread_collect_adjoint():
    seam = lat.Seam(s=4, slit_lo=5)
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.normal(size=(2, 10, 9)))
    Y = jnp.asarray(rng.normal(size=(2, 10, 9)))
    # canonical X (mirror slots zero)
    Xc = X.at[:, seam.s + 1, :seam.slit_lo].set(0.0)
    lhs = jnp.vdot(lat.seam_spread(Xc, seam), Y)
    rhs = jnp.vdot(Xc, lat.seam_collect(Y, seam))
    assert float(abs(lhs - rhs)) < 1e-12 * (float(abs(lhs)) + 1)


@pytest.mark.parametrize("with_split", [False, True])
def test_seam_matvec_equals_assembled(with_split):
    """The conjugated lattice matvec (collect . A_lat . spread) must
    equal the generic gather/scatter stored-matrix operator — the slit
    mesh's true global Jacobian action — for the u block, the p block
    and the J_pu coupling block."""
    mesh, lay, jacL, jac, ca = _slit_context(3, with_split)
    seam = lay.seam
    vp = jnp.asarray(lay.vert_pos)
    rng = np.random.default_rng(2)
    n_v = mesh.n_vertices
    from cracks_tpu.solvers import assembled

    x = jnp.asarray(rng.normal(size=n_v * 2))
    y_ref = assembled.matvec_uu(jac, ca, x, dim=2)
    Xs = lat.seam_spread(lat._to_lat(x, vp, lay.grid, 2), seam)
    Y = lat.seam_collect(lat.matvec(jacL, Xs, 0, 8, 2), seam)
    np.testing.assert_allclose(np.asarray(lat._to_glob(Y, vp, 2)),
                               np.asarray(y_ref), rtol=1e-12,
                               atol=1e-14)

    xp = jnp.asarray(rng.normal(size=n_v))
    yp_ref = assembled.matvec_pp(jac, ca, xp, dim=2)
    Xp = lat.seam_spread(lat._to_lat(xp, vp, lay.grid, 1), seam)
    Yp = lat.seam_collect(lat.matvec(jacL, Xp, 8, 12, 1), seam)
    np.testing.assert_allclose(np.asarray(lat._to_glob(Yp, vp, 1)),
                               np.asarray(yp_ref), rtol=1e-12,
                               atol=1e-14)

    # J_pu coupling (consumed by the p-block rhs in the split solves)
    ypu_ref = assembled.matvec_pu(jac, ca, x, n_v, dim=2)
    Ypu = lat.seam_collect(
        lat.matvec_block(jacL, Xs, 8, 12, 0, 8, 2, 1), seam)
    np.testing.assert_allclose(np.asarray(lat._to_glob(Ypu, vp, 1)),
                               np.asarray(ypu_ref), rtol=1e-12,
                               atol=1e-14)


def test_seam_prolong_restrict_transpose():
    """prolong_seam / restrict_seam are adjoint on canonical vectors."""
    seam_f = lat.Seam(s=8, slit_lo=9)
    seam_c = lat.seam_coarse(seam_f)
    grid_f, grid_c = (18, 17), (10, 9)
    assert lat._seam_coarse_grid(grid_f, seam_f) == grid_c
    rng = np.random.default_rng(3)
    for k in (1, 2):
        Xc = jnp.asarray(rng.normal(size=(k,) + grid_c))
        Xc = Xc.at[:, seam_c.s + 1, :seam_c.slit_lo].set(0.0)
        Yf = jnp.asarray(rng.normal(size=(k,) + grid_f))
        Yf = Yf.at[:, seam_f.s + 1, :seam_f.slit_lo].set(0.0)
        P = lat.prolong_seam(Xc, grid_f, k, seam_f)
        # prolongation of a canonical field is canonical
        assert float(jnp.max(jnp.abs(
            P[:, seam_f.s + 1, :seam_f.slit_lo]))) == 0.0
        lhs = jnp.vdot(P, Yf)
        rhs = jnp.vdot(Xc, lat.restrict_seam(Yf, k, seam_f))
        assert float(abs(lhs - rhs)) < 1e-12 * (float(abs(lhs)) + 1)


def test_seam_prolong_continuity():
    """Prolongation across the glued region interpolates the SHARED
    value into both lips (consistency), and lets the duplicated columns
    differ."""
    seam_f = lat.Seam(s=8, slit_lo=9)
    seam_c = lat.seam_coarse(seam_f)
    grid_f, grid_c = (18, 17), (10, 9)
    rng = np.random.default_rng(4)
    Xc = jnp.asarray(rng.normal(size=(1,) + grid_c))
    Xc = Xc.at[:, seam_c.s + 1, :seam_c.slit_lo].set(0.0)
    P = lat.prolong_seam(Xc, grid_f, 1, seam_f)
    spread = lat.seam_spread(P, seam_f)
    # glued fine columns: both lips carry the same interpolant
    np.testing.assert_allclose(
        np.asarray(spread[0, seam_f.s, :seam_f.slit_lo]),
        np.asarray(spread[0, seam_f.s + 1, :seam_f.slit_lo]),
        atol=1e-14)
    # duplicated columns may (and generically do) differ
    assert float(jnp.max(jnp.abs(
        spread[0, seam_f.s, seam_f.slit_lo:]
        - spread[0, seam_f.s + 1, seam_f.slit_lo:]))) > 1e-8


@pytest.mark.parametrize("which,lo,hi,k", [("u", 0, 8, 2),
                                           ("p", 8, 12, 1)])
def test_seam_galerkin_coarsening_identity(which, lo, hi, k):
    """coarsen_seam is EXACTLY Galerkin: the conjugated coarse matvec
    equals restrict . (conjugated fine matvec) . prolong on canonical
    coarse vectors (f64, per-slab element-RAP; see coarsen_seam)."""
    mesh, lay, jacL, jac, ca = _slit_context(3)
    seam_f = lay.seam
    seam_c = lat.seam_coarse(seam_f)
    grid_f = lay.grid
    grid_c = lat._seam_coarse_grid(grid_f, seam_f)
    P_embed = jnp.asarray(
        __import__("cracks_tpu.solvers.galerkin",
                   fromlist=["embedding_matrices"])
        .embedding_matrices(2), jnp.float64)
    jacC = lat.coarsen_seam(jacL, P_embed, seam_f)
    rng = np.random.default_rng(5)
    Xc = jnp.asarray(rng.normal(size=(k,) + grid_c))
    Xc = Xc.at[:, seam_c.s + 1, :seam_c.slit_lo].set(0.0)

    def conj_mv(J, X, seam):
        return lat.seam_collect(
            lat.matvec(J, lat.seam_spread(X, seam), lo, hi, k), seam)

    y_coarse = conj_mv(jacC, Xc, seam_c)
    y_rap = lat.restrict_seam(
        conj_mv(jacL, lat.prolong_seam(Xc, grid_f, k, seam_f), seam_f),
        k, seam_f)
    np.testing.assert_allclose(np.asarray(y_coarse), np.asarray(y_rap),
                               rtol=1e-10, atol=1e-12)


def _miehe_sim(max_steps=2):
    """The shipped miehe_shear_2 config truncated to two load steps
    (step >= 1 turns the split matrix on), on the lattice-eligible
    GMG + mixed-precision solver knobs (the bench's solver overrides; the
    prm itself selects the direct inner solver)."""
    import os
    from cracks_tpu.config import load_parameters
    from cracks_tpu.driver import REPO_ROOT, Simulation
    prm = os.path.join(REPO_ROOT, "params", "tests",
                       "miehe_shear_2.prm")
    p = load_parameters(prm, max_no_timesteps=max_steps, output_dir="",
                        linear_solver="cg", direct_solver=False,
                        preconditioner="gmg", mixed_precision_cg=True,
                        cg_rtol=1e-8)
    return Simulation(p, verbose=False)


def test_seam_solve_matches_galerkin():
    """End-to-end: the miehe shear load steps through the seam-glued
    lattice solve must reproduce the forced-Galerkin (gather-path)
    statistics — two implementations of the same Newton systems."""
    sim_l = _miehe_sim()
    sim_l.run()
    assert sim_l.sys.lattice_hierarchy is not None
    assert sim_l.sys.lattice_hierarchy.seam is not None

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
        sim_g = _miehe_sim()
        sim_g.run()
        assert sim_g.sys.galerkin_hierarchy is not None
    finally:
        drv.Simulation.setup_system = orig
    for colname in ("Bulk Energy", "Crack Energy", "Load x"):
        a = sim_l.statistics.data[colname][-1]
        b = sim_g.statistics.data[colname][-1]
        assert b == pytest.approx(a, rel=1e-8, abs=1e-12), colname


def test_seam_split_solve_matches_fused(monkeypatch):
    """The split-dispatch production variant on the seam lattice must
    reproduce the fused solve's statistics (the path miehe shear takes
    at production sizes)."""
    sim_f = _miehe_sim()
    sim_f.run()
    assert sim_f.sys.lattice_hierarchy.seam is not None
    monkeypatch.setattr(lat, "FUSED_SOLVE_MAX_DOFS", 0)
    sim_s = _miehe_sim()
    sim_s.run()
    for colname in ("Bulk Energy", "Crack Energy", "Load x"):
        a = sim_f.statistics.data[colname][-1]
        b = sim_s.statistics.data[colname][-1]
        assert b == pytest.approx(a, rel=1e-8, abs=1e-12), colname
