"""Benchmark: wall-clock per load step on the BASELINE.json workloads.

Runs the configured workload (quasi-monolithic PDAS phase-field
fracture, float64 outer / float32 Krylov, lattice/Galerkin GMG) in this
process on the GPU and prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "platform", "device_kind",
 "device_count", "card"} — "card" is nvidia-smi's name and power limit.
It refuses to run on any other backend, and a failed run is a failure:
nothing is retried and no smaller problem is substituted.

    python bench.py

Baseline: the reference (deal.II + Trilinos, MPI) publishes no
wall-clock numbers in-repo (BASELINE.md).  As a provisional anchor we
use an estimated 15 s per load step for deal.II's assembled-matrix
GMRES+AMG pipeline on the same problem at ~300k DoFs on one CPU socket
— derived from the reference's own solver-effort counters (3-4 Newton x
4-6 GMRES its per step, tests/sneddon_2d_1.output) and typical deal.II
assembly throughput (~1e5 cells/s/core for this 3x3-quadrature
vector-valued kernel), scaled linearly in DoFs.  A measured
same-machine SuperLU bound corroborates the anchor as conservative
(scripts/baseline_anchor.json, BASELINE.md).

Environment knobs:
  BENCH_CASE     sneddon (default) | hetero_3d | adaptive | miehe_shear
                 - sneddon:  pressurized static crack (2d/3d by
                   BENCH_DIM), uniform lattice mesh — the north-star
                   1M-DoF config at the defaults
                 - hetero_3d: the multiple-het 3d bitmap-material
                   workload (parameters_hetero_3d.prm physics) on its
                   production locally-prerefined (hanging-node) mesh;
                   BENCH_LOCAL local pre-refinement steps (default 5,
                   the reference config's value)
                 - adaptive: Sneddon 2d with one predictor-corrector
                   refinement cycle; reports s/step ON THE ADAPTED
                   (hanging-node) mesh
                 - miehe_shear: the miehe_shear_2 crack-growth
                   trajectory (25 load steps through the softening
                   branch, spectral split in matrix+rhs, fixed mesh) at
                   a scaled-up refinement; reports mean s/step over the
                   whole trajectory
  BENCH_REFINE   global refinements of the root grid (case-specific
                 defaults)
  BENCH_DIM      sneddon only: 2 (default) or 3
  BENCH_STEPS    timed load steps (default 2)
  BENCH_DTYPE    float64 (default) or float32
  BENCH_PRECOND  gmg (default) or jacobi
"""

import json
import os
import subprocess
import sys
import time


_HERE = os.path.dirname(os.path.abspath(__file__))


def _load_prm(name, fallback_kwargs):
    from cracks_tpu.config import Parameters, load_parameters
    path = os.path.join(_HERE, "params", name)
    if os.path.exists(path):
        return load_parameters(path)
    return Parameters(**fallback_kwargs)


def _solver_overrides(precond, dtype, n_steps):
    return dict(
        max_no_timesteps=n_steps - 1, output_dir="",
        linear_solver="cg", preconditioner=precond, cg_rtol=1e-8,
        cg_maxiter=3000, dtype=dtype,
        mixed_precision_cg=(os.environ.get("BENCH_MIXED", "1") == "1"))


def _make_params(case, refine, dtype, precond, n_steps, dim=2):
    if case == "hetero_3d":
        p = _load_prm("parameters_hetero_3d.prm", dict(
            test_case="multiple het", dimension=3,
            pressure_expr="0 + time *1e3", G_c=1.0,
            poisson_ratio_nu=0.2, E_modulus=1e4,
            k_reg_expr="1e-10*h", eps_reg_expr="0.1",
            lower_bound_newton_residual=1e-6, max_no_newton_steps=50,
            max_no_line_search_steps=8, timestep_size=0.005))
        # the hetero-3d ladder needs global+local >= 8 levels for the
        # fixed Eps reg = 0.1 to satisfy eps >= h (reference config:
        # global 3 + local 5, parameters_hetero_3d.prm); the bench
        # default global 5 + local 5 lands ~300k DoFs
        local = int(os.environ.get("BENCH_LOCAL", "5"))
        return p.replace(
            n_global_pre_refine=refine, n_local_pre_refine=local,
            n_refinement_cycles=0, **_solver_overrides(precond, dtype,
                                                    n_steps))
    if case == "miehe_shear":
        p = _load_prm(os.path.join("tests", "miehe_shear_2.prm"), dict(
            test_case="miehe shear", G_c=2.7, poisson_ratio_nu=0.2,
            E_modulus=1e3, lame_mu=80.77e3, lame_lambda=121.15e3,
            k_reg_expr="1.0e-10*h", eps_reg_expr="2*h",
            lower_bound_newton_residual=1e-6, max_no_newton_steps=100,
            max_no_line_search_steps=10, line_search_damping=0.6,
            decompose_stress_rhs=1.0, decompose_stress_matrix=1.0,
            timestep_size=5e-4, switch_timestep=1000,
            max_no_timesteps=24))
        ov = _solver_overrides(precond, dtype, n_steps)
        # the trajectory IS the benchmark: always run the full 25
        # steps of the golden load-displacement curve
        ov["max_no_timesteps"] = 24
        # all cells sit at the level cap, so the phase-field refinement
        # strategy never fires and the mesh stays fixed (the scaled-up
        # analogue of the 891-DoF golden config)
        return p.replace(n_global_pre_refine=refine,
                         n_local_pre_refine=0, n_refinement_cycles=0,
                         **ov)
    name = ("parameters_sneddon_2d.prm" if dim == 2
            else "parameters_sneddon_3d.prm")
    p = _load_prm(name, dict(
        test_case="sneddon", pressure_expr="1.0e-3", G_c=1.0,
        poisson_ratio_nu=0.2, E_modulus=1.0, k_reg_expr="1e-8*h",
        eps_reg_expr="2.0*h", lower_bound_newton_residual=1e-7,
        max_no_newton_steps=50, max_no_line_search_steps=10,
        dimension=dim))
    cycles = 1 if case == "adaptive" else 0
    return p.replace(
        n_global_pre_refine=refine, n_local_pre_refine=0,
        n_refinement_cycles=cycles,
        **_solver_overrides(precond, dtype, n_steps))


def _run_once(case, refine, dtype, precond, n_steps, dim):
    from cracks_tpu.driver import Simulation

    if case == "adaptive":
        # one run: uniform steps to stationarity, refinement cycle,
        # steps on the adapted (hanging-node) mesh to stationarity.
        # The timed metric is s/step on the FINAL (adapted) mesh,
        # excluding that epoch's first step (which carries the epoch's
        # compiles).
        print(f"# adaptive single-run start: refine={refine}",
              file=sys.stderr, flush=True)
        p = _make_params(case, refine, dtype, precond, 30, dim)
        sim = Simulation(p, verbose=False)
        t0 = time.time()
        sim.run()
        wall = time.time() - t0
        warm = sim.step_times[0][2] if sim.step_times else wall
        n_dofs = sim.mesh.n_dofs
        final_steps = [t for (_n, d, t) in sim.step_times
                       if d == n_dofs]
        if not final_steps:
            raise RuntimeError("adaptive bench: no steps on the "
                               "adapted mesh")
        if len(final_steps) > 1:
            final_steps = final_steps[1:]
        per_step = sum(final_steps) / len(final_steps)
        # uniform-epoch comparison (target: adaptive step <= 2x the
        # uniform step at equal DoFs): per-step seconds per MDoF on
        # the pre-refinement uniform mesh vs the adapted mesh
        uni = [(d, t) for (_n, d, t) in sim.step_times if d != n_dofs]
        if len(uni) > 1:
            uni = uni[1:]   # drop the compile-laden first step
        if uni:
            uni_per_mdof = (sum(t for _d, t in uni) / len(uni)
                            / (uni[0][0] / 1e6))
            ada_per_mdof = per_step / (n_dofs / 1e6)
            print(f"# adaptive: uniform epoch {uni[0][0]} dofs "
                  f"{uni_per_mdof:.2f} s/step/MDoF vs adapted "
                  f"{n_dofs} dofs {ada_per_mdof:.2f} s/step/MDoF "
                  f"(ratio {ada_per_mdof / uni_per_mdof:.2f})",
                  file=sys.stderr)
        bulk = sim.statistics.data["Bulk Energy"][-1]
        return n_dofs, warm, wall, per_step, len(final_steps), bulk

    if case == "hetero_3d":
        # single run: the predictor-corrector trajectory visits a NEW
        # mesh epoch per refinement, so a separate "warm" rerun would
        # re-pay every compile.  Report the mean over the steps after
        # the first (the first step carries most compiles); per-epoch
        # compile overhead on later refinements stays included, which
        # is conservative against us.
        print(f"# hetero_3d single-run start: refine={refine}",
              file=sys.stderr, flush=True)
        p = _make_params(case, refine, dtype, precond,
                         max(n_steps + 1, 3), dim)
        sim = Simulation(p, verbose=False)
        t0 = time.time()
        sim.run()
        wall = time.time() - t0
        n_dofs = sim.mesh.n_dofs
        times = [t for (_n, _d, t) in sim.step_times]
        tail = times[1:] if len(times) > 1 else times
        per_step = sum(tail) / len(tail)
        bulk = sim.statistics.data["Bulk Energy"][-1]
        return n_dofs, times[0], wall, per_step, len(tail), bulk

    if case == "miehe_shear":
        # no separate warmup: the 25-step trajectory amortizes its own
        # compiles; report the mean over the last 20 steps (the first
        # steps carry the compile cost) plus the full-run wall clock
        print(f"# trajectory start: case=miehe_shear refine={refine}",
              file=sys.stderr, flush=True)
        p = _make_params(case, refine, dtype, precond, n_steps, dim)
        sim = Simulation(p, verbose=False)
        t0 = time.time()
        sim.run()
        wall = time.time() - t0
        n_dofs = sim.mesh.n_dofs
        times = [t for (_n, _d, t) in sim.step_times]
        tail = times[5:] if len(times) > 10 else times
        per_step = sum(tail) / len(tail)
        bulk = sim.statistics.data["Bulk Energy"][-1]
        return n_dofs, times[0], wall, per_step, len(tail), bulk

    # warmup run (1 step): pays all JIT compilation (persistently
    # cached)
    print(f"# warmup start: case={case} refine={refine}",
          file=sys.stderr, flush=True)
    p1 = _make_params(case, refine, dtype, precond, 1, dim)
    sim = Simulation(p1, verbose=False)
    t0 = time.time()
    sim.run()
    warm = time.time() - t0
    n_dofs = sim.mesh.n_dofs
    print(f"# warmup done: {n_dofs} dofs in {warm:.1f}s; timed run "
          f"starting", file=sys.stderr, flush=True)

    # timed run: compiles come from the cache, so wall/steps is the
    # steady-state per-step cost (including mesh/setup amortized)
    p2 = _make_params(case, refine, dtype, precond, n_steps, dim)
    sim2 = Simulation(p2, verbose=False)
    t0 = time.time()
    sim2.run()
    wall = time.time() - t0
    bulk = sim2.statistics.data["Bulk Energy"][-1]
    return n_dofs, warm, wall, wall / n_steps, n_steps, bulk


def _resolve_config():
    case = os.environ.get("BENCH_CASE", "sneddon")
    dim = int(os.environ.get("BENCH_DIM", "2"))
    if case == "hetero_3d":
        dim = 3
    if case in ("adaptive", "miehe_shear"):
        dim = 2
    defaults = {"sneddon": "6" if dim == 2 else "2",
                "hetero_3d": "5", "adaptive": "5", "miehe_shear": "8"}
    refine = int(os.environ.get("BENCH_REFINE", defaults[case]))
    n_steps = int(os.environ.get("BENCH_STEPS", "2"))
    dtype = os.environ.get("BENCH_DTYPE", "float64")
    precond = os.environ.get("BENCH_PRECOND", "gmg")
    if (case == "sneddon" and dim == 3
            and "CRACKS_TPU_SNEDDON_REPS" not in os.environ):
        # 11^3 roots x refine 2 = 85,184 cells, 364k DoFs (>= 300k)
        os.environ["CRACKS_TPU_SNEDDON_REPS"] = "11"
    return case, dim, refine, n_steps, dtype, precond


def _card():
    """nvidia-smi's name and power limit of the first card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def main():
    sys.path.insert(0, _HERE)
    import jax

    import cracks_tpu  # noqa: F401  (x64 and the compile cache)

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX runs on "
                         f"{backend}")
    devs = jax.devices()
    card = _card()
    case, dim, refine, n_steps, dtype, precond = _resolve_config()
    (n_dofs, warm, wall, per_step, counted,
     bulk) = _run_once(case, refine, dtype, precond, n_steps, dim)
    baseline_s_per_step = 15.0 * (n_dofs / 3.0e5)  # see module docstring
    tag = {"sneddon": f"sneddon{dim}d",
           "hetero_3d": "hetero3d",
           "adaptive": "sneddon2d_adaptive",
           "miehe_shear": "miehe_shear2_traj"}[case]
    print(f"# case={case} dim={dim} dofs={n_dofs} steps={counted} "
          f"dtype={dtype} precond={precond} warmup={warm:.1f}s "
          f"timed={wall:.1f}s bulk_energy={bulk:.6e}", file=sys.stderr)
    print(json.dumps({
        "metric": f"{tag}_{n_dofs}dofs_seconds_per_load_step",
        "value": round(per_step, 3),
        "unit": "s",
        "vs_baseline": round(baseline_s_per_step / per_step, 3),
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": card,
    }), flush=True)


if __name__ == "__main__":
    main()
