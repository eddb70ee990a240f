"""Multi-device golden parity: the production PDAS solver on an
8-device mesh must reproduce the single-device statistics.

This is the analogue of the reference's np1/np2 golden pair
(tests/miehe_shear_2.statistics vs .mpirun=2.statistics, compared with
numdiff -a 1e-6 -r 1e-8, tests/run_test.sh:13): the same simulation is
run with the element arrays sharded over all 8 virtual devices
(driver System n_devices=8, GSPMD partitioning with cross-device collectives
inserted by XLA) through the FULL production stack — PDAS active-set
Newton, stored-element-matrix CG, Galerkin GMG preconditioner — and
the statistics table must agree with the 1-device run and the golden
reference data within numdiff tolerances."""

import numpy as np
import pytest

from cracks_tpu.driver import run_prm

from .regression import PRM_DIR, load_golden, parse_statistics


def _run(n_devices, tmp_path, **overrides):
    sim, _ = run_prm(f"{PRM_DIR}/miehe_shear_2.prm",
                     output_dir=str(tmp_path / f"np{n_devices}"),
                     max_no_timesteps=3, n_devices=n_devices,
                     linear_solver="cg", preconditioner="gmg",
                     cg_rtol=1e-10, **overrides)
    return parse_statistics(sim.statistics.write_text())


@pytest.mark.parametrize("mixed", [False, True],
                         ids=["f64", "mixed-fused"])
def test_miehe_shear2_np1_equals_np8(tmp_path, mixed):
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    names1, rows1 = _run(1, tmp_path, mixed_precision_cg=mixed)
    names8, rows8 = _run(8, tmp_path, mixed_precision_cg=mixed)
    assert names1 == names8
    assert rows1.shape == rows8.shape
    diff = np.abs(rows1 - rows8)
    rel = diff / np.maximum(np.abs(rows1), 1e-300)
    assert ((diff <= 1e-6) | (rel <= 1e-8)).all(), (rows1, rows8)

    # and both match the reference golden rows (numdiff tolerances)
    g_names, g_rows = load_golden("miehe_shear_2.statistics")
    g = g_rows[: rows8.shape[0]]
    diff = np.abs(rows8[:, : g.shape[1]] - g)
    rel = diff / np.maximum(np.abs(g), 1e-300)
    assert ((diff <= 1e-6) | (rel <= 1e-8)).all(), (rows8, g)


def test_sneddon_lattice_np1_equals_np8(tmp_path):
    """np parity through the LATTICE fast path (the production solver
    for tensor-grid meshes): a Sneddon step with the cell axis sharded
    over all 8 devices must reproduce the 1-device lattice statistics.
    Mirrors the reference's distributed-solve goldens
    (tests/sneddon_3d_1.mpirun=4.*)."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")

    def run(n_dev):
        sim, _ = run_prm(f"{PRM_DIR}/sneddon_2d_1.prm",
                         output_dir=str(tmp_path / f"lat{n_dev}"),
                         n_global_pre_refine=3, n_local_pre_refine=0,
                         n_refinement_cycles=0, max_no_timesteps=0,
                         n_devices=n_dev, linear_solver="cg",
                         preconditioner="gmg", cg_rtol=1e-8,
                         mixed_precision_cg=True)
        assert sim.sys.lattice_hierarchy is not None, \
            "lattice fast path must be engaged"
        return parse_statistics(sim.statistics.write_text())

    names1, rows1 = run(1)
    names8, rows8 = run(8)
    assert names1 == names8
    diff = np.abs(rows1 - rows8)
    rel = diff / np.maximum(np.abs(rows1), 1e-300)
    assert ((diff <= 1e-6) | (rel <= 1e-8)).all(), (rows1, rows8)


def test_sneddon_split_solve_np1_equals_np8(tmp_path, monkeypatch):
    """np parity through the SPLIT-DISPATCH lattice solve — the
    production path for >150k-DoF problems (the refine-6 north-star
    configuration, lattice._solve_split) — forced at test size by
    lowering the fused-solve threshold.  Covers the f64 setup /
    all-f32 CG / f64 refine dispatch chain and the split-operator
    cache under GSPMD cell-axis sharding."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    import cracks_tpu.solvers.lattice as lat
    monkeypatch.setattr(lat, "FUSED_SOLVE_MAX_DOFS", 0)

    def run(n_dev):
        sim, _ = run_prm(f"{PRM_DIR}/sneddon_2d_1.prm",
                         output_dir=str(tmp_path / f"split{n_dev}"),
                         n_global_pre_refine=3, n_local_pre_refine=0,
                         n_refinement_cycles=0, max_no_timesteps=0,
                         n_devices=n_dev, linear_solver="cg",
                         preconditioner="gmg", cg_rtol=1e-8,
                         mixed_precision_cg=True)
        assert sim.sys.lattice_hierarchy is not None
        assert getattr(sim.sys, "_split_jac_cache", None) is not None, \
            "split-dispatch solve must be engaged"
        return parse_statistics(sim.statistics.write_text())

    names1, rows1 = run(1)
    names8, rows8 = run(8)
    assert names1 == names8
    diff = np.abs(rows1 - rows8)
    rel = diff / np.maximum(np.abs(rows1), 1e-300)
    assert ((diff <= 1e-6) | (rel <= 1e-8)).all(), (rows1, rows8)


@pytest.mark.slow
def test_sneddon_3d_split_solve_np1_equals_np8(tmp_path, monkeypatch):
    """3d analogue of the split-solve parity test, mirroring the
    reference's distributed 3d golden (tests/sneddon_3d_1.mpirun=4.*):
    a Sneddon 3d penny-crack step through the octree-lattice
    split-dispatch solve with the cell axis sharded over 8 devices must
    reproduce the single-device statistics."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    import cracks_tpu.solvers.lattice as lat
    monkeypatch.setattr(lat, "FUSED_SOLVE_MAX_DOFS", 0)

    def run(n_dev):
        sim, _ = run_prm(f"{PRM_DIR}/sneddon_3d_1.prm",
                         output_dir=str(tmp_path / f"split3d{n_dev}"),
                         n_global_pre_refine=1, n_local_pre_refine=0,
                         n_refinement_cycles=0, max_no_timesteps=0,
                         n_devices=n_dev, linear_solver="cg",
                         preconditioner="gmg", cg_rtol=1e-8,
                         mixed_precision_cg=True)
        assert sim.sys.lattice_hierarchy is not None, \
            "3d lattice fast path must be engaged"
        assert getattr(sim.sys, "_split_jac_cache", None) is not None, \
            "split-dispatch solve must be engaged"
        return parse_statistics(sim.statistics.write_text())

    names1, rows1 = run(1)
    names8, rows8 = run(8)
    assert names1 == names8
    diff = np.abs(rows1 - rows8)
    rel = diff / np.maximum(np.abs(rows1), 1e-300)
    assert ((diff <= 1e-6) | (rel <= 1e-8)).all(), (rows1, rows8)


def test_adaptive_amr_np1_equals_np8(tmp_path):
    """Post-AMR repartitioning: an ADAPTIVE (predictor-corrector) run
    with the element arrays sharded over 8 devices must reproduce the
    single-device statistics ACROSS mesh epochs.

    Every refinement rebuilds the cell arrays from the new forest and
    re-shards them evenly over the device mesh (driver.System via
    parallel/sharding) — the Morton-ordered cell axis makes the
    re-split trivial, which is the structured-mesh answer to the
    reference's p4est repartition-on-refine
    (cracks.cc:4147 execute_coarsening_and_refinement).  miehe_shear_1
    crosses two refinements (891 -> 918 -> 984 DoFs) inside the run, so
    agreement here proves solution transfer + re-setup + re-sharding
    compose across epochs, mirroring the reference's np1/np2 golden
    discipline on an adaptive trajectory."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")

    def run(n_dev):
        sim, _ = run_prm(f"{PRM_DIR}/miehe_shear_1.prm",
                         output_dir=str(tmp_path / f"amr{n_dev}"),
                         max_no_timesteps=7, n_devices=n_dev,
                         linear_solver="cg", preconditioner="gmg")
        assert sim.mesh.n_dofs == 984  # two refinements happened
        return parse_statistics(sim.statistics.write_text())

    names1, rows1 = run(1)
    names8, rows8 = run(8)
    assert names1 == names8
    diff = np.abs(rows1 - rows8)
    rel = diff / np.maximum(np.abs(rows1), 1e-300)
    assert ((diff <= 1e-6) | (rel <= 1e-8)).all(), (rows1, rows8)

    g_names, g_rows = load_golden("miehe_shear_1.statistics")
    g = g_rows[: rows8.shape[0]]
    diff = np.abs(rows8[:, : g.shape[1]] - g)
    rel = diff / np.maximum(np.abs(g), 1e-300)
    assert ((diff <= 1e-6) | (rel <= 1e-8)).all(), (rows8, g)
