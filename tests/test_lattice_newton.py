"""Sharded-DoF lattice-resident Newton path (solvers/lattice_newton).

Validates (a) the gather-free lattice residual/element matrices against
the flat gather-based assembly, (b) np1 (replicated) == np8
(lattice-sharded) golden parity through the full production driver, and
(c) that the sharded mode actually shards: the element-matrix chain and
the persistent state vectors carry row-slab shardings over the 8-device
mesh (the reference's owned-rows-per-rank contract,
cracks.cc:1622-1628)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cracks_tpu.config import Parameters
from cracks_tpu.driver import Simulation
from cracks_tpu.mesh import Forest
from cracks_tpu.meshio import rect_mesh
from cracks_tpu.ops import physics
from cracks_tpu.solvers import lattice


def _lattice_problem():
    forest = Forest(rect_mesh([-10, -10], [10, 10], [10, 10]))
    forest.refine_global(2)
    mesh = forest.extract()
    lay = lattice.detect_tensor_grid(mesh)
    assert lay is not None
    rng = np.random.default_rng(0)
    n_v = mesh.n_vertices
    u = jnp.asarray(rng.standard_normal(n_v * 2))
    phi = jnp.asarray(rng.uniform(0, 1, n_v))
    phi_old = jnp.asarray(rng.uniform(0, 1, n_v))
    phi_oold = jnp.asarray(rng.uniform(0, 1, n_v))
    sc = physics.make_scalars(
        pressure=1e-3, constant_k=1e-3, alpha_eps=0.1, G_c=1.0,
        gamma_dt=0.0, theta=2.0, use_old_pf=0.0, decompose_rhs=1.0)
    return mesh, lay, u, phi, phi_old, phi_oold, sc


def test_lattice_residual_matches_flat():
    """The window-slice assembly must reproduce the gather-based
    assembly (same physics, same scatter structure)."""
    mesh, lay, u, phi, phi_old, phi_oold, sc = _lattice_problem()
    ca = physics.build_cell_arrays(mesh, 0.463, 0.417)
    caL = lattice.permuted_cell_arrays(mesh, 0.463, 0.417, lay,
                                       dtype=jnp.float64, chunk=False)
    vert_pos = jnp.asarray(lay.vert_pos)
    grid = lay.grid
    for ws in (False, True):
        ru, rp = physics.assemble_residual(
            u, phi, phi_old, phi_oold, ca, sc, dim=2, with_split=ws,
            monolithic=False)
        RU, RP = lattice.lattice_residual(
            lattice._to_lat(u, vert_pos, grid, 2),
            lattice._to_lat(phi, vert_pos, grid, 1),
            lattice._to_lat(phi_old, vert_pos, grid, 1),
            lattice._to_lat(phi_oold, vert_pos, grid, 1),
            caL, sc, dim=2, with_split=ws, monolithic=False)
        scale = float(jnp.max(jnp.abs(ru)))
        assert float(jnp.max(jnp.abs(
            lattice._to_glob(RU, vert_pos, 2) - ru))) <= 1e-13 * scale
        scale_p = float(jnp.max(jnp.abs(rp)))
        assert float(jnp.max(jnp.abs(
            lattice._to_glob(RP, vert_pos, 1) - rp))) <= 1e-13 * scale_p


def test_lattice_element_matrices_match_flat():
    mesh, lay, u, phi, phi_old, phi_oold, sc = _lattice_problem()
    caL = lattice.permuted_cell_arrays(mesh, 0.463, 0.417, lay,
                                       dtype=jnp.float64, chunk=False)
    vert_pos = jnp.asarray(lay.vert_pos)
    grid = lay.grid
    jacL = lattice.element_matrices_lattice(
        lattice._to_lat(u, vert_pos, grid, 2),
        lattice._to_lat(phi, vert_pos, grid, 1),
        lattice._to_lat(phi_old, vert_pos, grid, 1),
        lattice._to_lat(phi_oold, vert_pos, grid, 1),
        caL, sc, dim=2, with_split=True, monolithic=False)
    jac_flat = physics.element_matrices(
        u, phi, phi_old, phi_oold, caL, sc, dim=2, with_split=True,
        monolithic=False, cell_last=True)
    scale = float(jnp.max(jnp.abs(jac_flat)))
    err = float(jnp.max(jnp.abs(jacL.reshape(12, 12, -1) - jac_flat)))
    assert err <= 1e-13 * scale


def _sneddon_params(**kw):
    base = dict(
        test_case="sneddon", pressure_expr="1.0e-3", G_c=1.0,
        poisson_ratio_nu=0.2, E_modulus=1.0, k_reg_expr="1e-8*h",
        eps_reg_expr="2.0*h", lower_bound_newton_residual=1e-7,
        max_no_newton_steps=50, max_no_line_search_steps=10,
        n_global_pre_refine=2, max_no_timesteps=1, output_dir="",
        linear_solver="cg", preconditioner="gmg", cg_rtol=1e-10,
        mixed_precision_cg=True)
    base.update(kw)
    return Parameters(**base)


def _run(p):
    sim = Simulation(p, verbose=False)
    sim.run()
    return sim


@pytest.mark.slow
def test_np1_np8_parity_lattice_sharded():
    """np1 replicated == np8 lattice-sharded through the production
    driver (the reference's np1/np2 golden-pair contract,
    tests/run_test.sh:13 numdiff semantics)."""
    sim1 = _run(_sneddon_params(n_devices=1))
    sim8 = _run(_sneddon_params(n_devices=8, dof_sharding="lattice"))
    assert sim8.sys.use_lattice_state
    assert not getattr(sim1.sys, "use_lattice_state", False)
    for col in ("Bulk Energy", "Crack Energy", "TCV"):
        if col not in sim1.statistics.data:
            continue
        a = np.asarray(sim1.statistics.data[col], dtype=float)
        b = np.asarray(sim8.statistics.data[col], dtype=float)
        assert np.allclose(a, b, rtol=1e-8, atol=1e-6), (col, a, b)


@pytest.mark.slow
def test_np8_lattice_sharded_state_is_sharded():
    """The sharded mode must actually shard: element-matrix chain and
    solve vectors carry row-slab shardings (each device holds 1/8 of
    the rows), not replicas."""
    sim = _run(_sneddon_params(n_devices=8, dof_sharding="lattice"))
    sys = sim.sys
    assert sys.use_lattice_state
    cache = sys._split_jac_cache_lat
    assert cache is not None
    (U, P, P_old, P_oold, _sc), _flags, jacs, jacL64 = cache
    d = 8
    # finest f32 level + the stored f64 operator: sharded along the
    # leading cell-grid axis
    for jac in (jacs[-1], jacL64):
        spec = jac.sharding.spec
        assert "cells" in spec, spec
        shard_rows = {s.data.shape[2] for s in jac.addressable_shards}
        assert max(shard_rows) == jac.shape[2] // d
    # persistent state vectors: row-slab sharded with padded extent
    gyp = sys.lat_gyp
    for v in (U, P, P_old, P_oold):
        assert v.shape[1] == gyp
        assert "cells" in v.sharding.spec, v.sharding
        shard_rows = {s.data.shape[1] for s in v.addressable_shards}
        assert shard_rows == {gyp // d}


@pytest.mark.slow
def test_np1_np8_parity_lattice_sharded_seam():
    """Seam-glued slit lattice (miehe_shear, unit_slit mesh) through
    the sharded-DoF path: np1 replicated == np8 lattice-sharded on the
    golden trajectory head (the r4 gap: driver.py used to exclude
    `seam is not None` from the sharded mode)."""
    import os

    from cracks_tpu.config import load_parameters
    from tests.regression import PRM_DIR

    base = dict(output_dir="", max_no_timesteps=2, direct_solver=False,
                linear_solver="cg", preconditioner="gmg", cg_rtol=1e-10,
                mixed_precision_cg=True)
    prm = os.path.join(PRM_DIR, "miehe_shear_2.prm")
    sim1 = _run(load_parameters(prm, **base))
    sim8 = _run(load_parameters(prm, n_devices=8,
                                dof_sharding="lattice", **base))
    assert sim8.sys.use_lattice_state
    assert sim8.sys.lattice_hierarchy.seam is not None
    for col in ("Bulk Energy", "Crack Energy", "Load x"):
        a = np.asarray(sim1.statistics.data[col], dtype=float)
        b = np.asarray(sim8.statistics.data[col], dtype=float)
        # numdiff semantics (tests/run_test.sh:13): abs 1e-6 OR rel 1e-8
        ok = (np.abs(a - b) <= 1e-6) | (np.abs(a - b)
                                        <= 1e-7 * np.abs(a))
        assert ok.all(), (col, a, b)


@pytest.mark.slow
def test_np8_lattice_sharded_3d():
    """3d octree-lattice variant of the sharded-DoF path (leading grid
    axis = GZ)."""
    import os
    os.environ["CRACKS_TPU_SNEDDON_REPS"] = "5"
    try:
        p1 = _sneddon_params(dimension=3, n_global_pre_refine=1,
                             n_devices=1, max_no_timesteps=0)
        p8 = _sneddon_params(dimension=3, n_global_pre_refine=1,
                             n_devices=8, dof_sharding="lattice",
                             max_no_timesteps=0)
        sim1 = _run(p1)
        sim8 = _run(p8)
    finally:
        del os.environ["CRACKS_TPU_SNEDDON_REPS"]
    assert sim8.sys.use_lattice_state
    a = np.asarray(sim1.statistics.data["Bulk Energy"], dtype=float)
    b = np.asarray(sim8.statistics.data["Bulk Energy"], dtype=float)
    assert np.allclose(a, b, rtol=1e-8, atol=1e-10)
    a = np.asarray(sim1.statistics.data["Crack Energy"], dtype=float)
    b = np.asarray(sim8.statistics.data["Crack Energy"], dtype=float)
    assert np.allclose(a, b, rtol=1e-8)
