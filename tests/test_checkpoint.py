"""Checkpoint/resume round trip (a new capability — the reference keeps
run() state in memory only, SURVEY.md section 5)."""

import numpy as np

from cracks_tpu.checkpoint import load_checkpoint, save_checkpoint
from cracks_tpu.config import load_parameters
from cracks_tpu.driver import Simulation
import os
from tests import regression


def test_checkpoint_roundtrip(tmp_path):
    p = load_parameters(os.path.join(regression.PRM_DIR, "sneddon_2d_1.prm"),
                        output_dir="", max_no_timesteps=1)
    sim = Simulation(p, verbose=False)
    state = sim.run()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, sim, state)

    sim2, state2 = load_checkpoint(path, p)
    assert sim2.mesh.n_dofs == sim.mesh.n_dofs
    assert sim2.time == sim.time
    assert sim2.timestep_number == sim.timestep_number
    assert np.array_equal(np.asarray(state2.phi), np.asarray(state.phi))
    assert np.array_equal(np.asarray(state2.u), np.asarray(state.u))

    # resuming must reproduce the uninterrupted run's next step: run a
    # full sim to step 2, and separately continue the checkpoint by one
    # step, comparing energies
    p_full = p.replace(max_no_timesteps=2)
    sim_full = Simulation(p_full, verbose=False)
    sim_full.run()

    from cracks_tpu import qoi
    sim2.p = sim2.p.replace(max_no_timesteps=2)
    # drive one more step manually through the same machinery
    from cracks_tpu.solvers.newton import newton_active_set
    state2.phi_oold = state2.phi_old
    state2.phi_old = state2.phi
    state2.u_old = state2.u
    sim2.old_old_timestep = sim2.old_timestep
    sim2.old_timestep = sim2.timestep
    sim2.time += sim2.timestep
    sim2.use_old_timestep_pf = False
    sim2._set_context()
    newton_active_set(sim2.sys, state2, sim2.time, verbose=False)
    sim2.project_back_phase_field(state2)

    bulk2, crack2 = qoi.compute_energy(
        sim2.mesh, sim2._u_mat(state2), np.asarray(state2.phi),
        sim2.sys.lam_cells, sim2.sys.mu_cells,
        sim2.constant_k, sim2.alpha_eps, p.G_c)
    bulk_full = sim_full.statistics.data["Bulk Energy"][-1]
    assert abs(bulk2 - bulk_full) < 1e-12 * max(1.0, abs(bulk_full)) + 1e-14


def test_cli_checkpoint_and_resume_matches_uninterrupted(tmp_path):
    """The driver-reachable path (Checkpoint every / Resume from in the
    "TPU parameters" subsection): run 4 steps with a rolling checkpoint
    every 2 steps, resume the step-2 snapshot to step 4, and require the
    resumed statistics table to match the uninterrupted run
    digit-for-digit
    (same formatting; the checkpoint also carries the statistics rows
    so the rewritten file keeps its history)."""
    from cracks_tpu.driver import run_prm

    out_a = tmp_path / "full"
    sim_full, _ = run_prm(
        os.path.join(regression.PRM_DIR, "sneddon_2d_1.prm"),
        output_dir=str(out_a), max_no_timesteps=3)

    out_b = tmp_path / "ckpt"
    sim_b, _ = run_prm(
        os.path.join(regression.PRM_DIR, "sneddon_2d_1.prm"),
        output_dir=str(out_b), max_no_timesteps=1, checkpoint_every=2)
    ckpt = out_b / "checkpoint.npz"
    assert ckpt.exists()

    out_c = tmp_path / "resumed"
    sim_c, _ = run_prm(
        os.path.join(regression.PRM_DIR, "sneddon_2d_1.prm"),
        output_dir=str(out_c), max_no_timesteps=3,
        resume_from=str(ckpt))
    assert sim_c.timestep_number == sim_full.timestep_number

    full_txt = sim_full.statistics.write_text()
    resumed_txt = sim_c.statistics.write_text()
    a = regression.parse_statistics(full_txt)[1]
    b = regression.parse_statistics(resumed_txt)[1]
    assert a.shape == b.shape
    diff = np.abs(a - b)
    rel = diff / np.maximum(np.abs(a), 1e-300)
    both_empty = np.isnan(a) & np.isnan(b)   # '""' auto-fill cells
    assert ((diff <= 1e-6) | (rel <= 1e-8) | both_empty).all(), (a, b)


def test_cli_main_routes_resume(tmp_path, capsys):
    """`python -m cracks_tpu <prm> resume_from=...` must go through
    run_prm's checkpoint-resume path, not construct a fresh Simulation
    (regression: main() used to bypass run_prm and silently restart
    from timestep 0)."""
    from cracks_tpu.__main__ import main

    prm = os.path.join(regression.PRM_DIR, "sneddon_2d_1.prm")
    out_b, out_c = tmp_path / "intr", tmp_path / "res"
    assert main([prm, "max_no_timesteps=1", "checkpoint_every=1",
                 f"output_dir={out_b}"]) == 0
    capsys.readouterr()
    assert main([prm, "max_no_timesteps=2",
                 f"resume_from={out_b / 'checkpoint.npz'}",
                 f"output_dir={out_c}"]) == 0
    out = capsys.readouterr().out
    # a resumed run skips initialization and continues at step 2
    assert "Prerefinement" not in out
    assert "Timestep 0" not in out
    assert "Timestep 2" in out


def test_resume_carries_refinement_cycle_countdown(tmp_path):
    """A checkpoint taken AFTER a Sneddon stationarity refinement cycle
    carries the remaining-cycle countdown: the resumed run must NOT
    re-run `Adaptive refinement cycles` from the prm value (which would
    refine the mesh once more than the uninterrupted run).

    sneddon_2d_1 (1 refinement cycle): the uninterrupted 4-step run
    refines once at stationarity and ends on the 777-DoF mesh
    (tests/sneddon_2d_1.output:107).  The interrupted run's rolling
    per-step checkpoint ends with a snapshot of the refined mesh with 0
    cycles left; resuming it to the same step count must end on the
    same mesh with the countdown exhausted."""
    from cracks_tpu.driver import run_prm

    prm = os.path.join(regression.PRM_DIR, "sneddon_2d_1.prm")
    out_a = tmp_path / "full"
    sim_full, _ = run_prm(prm, output_dir=str(out_a), max_no_timesteps=5)
    assert sim_full.refinement_cycles_left == 0
    assert sim_full.mesh.n_dofs == 777

    # interrupted at the step whose stationarity consumed the one
    # refinement cycle: the rolling snapshot captures the refined mesh
    # and the exhausted countdown
    out_b = tmp_path / "ckpt"
    sim_b, _ = run_prm(prm, output_dir=str(out_b), max_no_timesteps=3,
                       checkpoint_every=1)
    assert sim_b.refinement_cycles_left == 0
    assert sim_b.mesh.n_dofs == 777

    out_c = tmp_path / "resumed"
    sim_c, _ = run_prm(prm, output_dir=str(out_c), max_no_timesteps=5,
                       resume_from=str(out_b / "checkpoint.npz"))
    assert sim_c.refinement_cycles_left == 0
    assert sim_c.mesh.n_dofs == sim_full.mesh.n_dofs
    a = regression.parse_statistics(sim_full.statistics.write_text())[1]
    b = regression.parse_statistics(sim_c.statistics.write_text())[1]
    assert a.shape == b.shape
    diff = np.abs(a - b)
    rel = diff / np.maximum(np.abs(a), 1e-300)
    both_empty = np.isnan(a) & np.isnan(b)
    assert ((diff <= 1e-6) | (rel <= 1e-8) | both_empty).all(), (a, b)
