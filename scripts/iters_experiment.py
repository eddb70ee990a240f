"""Measure linear-solver effort (CG its/solve) on the Sneddon lattice
path at a configurable refinement, on CPU.  Drives the production
split-dispatch solve (FUSED_MAX_DOFS=0) so pass structure matches the
bench at production sizes.  Usage:
  JAX_PLATFORMS=cpu CRACKS_TPU_FUSED_MAX_DOFS=0 python scripts/iters_experiment.py [refine]
"""
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("CRACKS_TPU_FUSED_MAX_DOFS", "0")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cracks_tpu.config import Parameters  # noqa: E402
from cracks_tpu.driver import Simulation  # noqa: E402

refine = int(sys.argv[1]) if len(sys.argv) > 1 else 4
steps = int(os.environ.get("EXP_STEPS", "2"))

p = Parameters(
    test_case="sneddon", dimension=2, pressure_expr="1.0e-3", G_c=1.0,
    poisson_ratio_nu=0.2, E_modulus=1.0, k_reg_expr="1e-8*h",
    eps_reg_expr="2.0*h", lower_bound_newton_residual=1e-7,
    max_no_newton_steps=50, max_no_line_search_steps=10,
    n_global_pre_refine=refine, n_local_pre_refine=0,
    n_refinement_cycles=0, max_no_timesteps=steps - 1, output_dir="",
    linear_solver="cg", preconditioner="gmg", cg_rtol=1e-8,
    cg_maxiter=3000, dtype="float64", mixed_precision_cg=True)

sim = Simulation(p, verbose=False)
t0 = time.time()
sim.run()
wall = time.time() - t0
tot_newton = sum(n for _s, n, _l in sim.solver_effort)
tot_lin = sum(l for _s, _n, l in sim.solver_effort)
print(f"refine={refine} dofs={sim.mesh.n_dofs} steps={len(sim.solver_effort)}")
for s, n, l in sim.solver_effort:
    print(f"  step {s}: newton={n} linear={l} ({l / max(n,1):.1f}/solve)")
print(f"TOTAL newton={tot_newton} linear={tot_lin} "
      f"avg={tot_lin / max(tot_newton,1):.1f} its/solve wall={wall:.1f}s")
