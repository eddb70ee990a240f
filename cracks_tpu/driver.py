"""Time-stepping driver: the orchestration loop of the framework.

Reimplements the reference's run() (cracks.cc:4166-4581): load stepping
with time-step switching, solver-failure step cutting, predictor-
corrector mesh adaptivity (redo the step whenever the mesh changed),
the Sneddon pseudo-time stationarity criterion with refinement cycles,
statistics recording and VTU output.

Host-side control flow (Python) around jitted device kernels — the same
layering as the reference, where run() is serial C++ around the
MPI/Trilinos compute kernels.
"""

from __future__ import annotations

import os
import sys
import time as walltime
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from . import meshio, problems, qoi
from .config import Parameters, dump_parameters
from .fem import element_tables, lumped_mass_diag
from .mesh import Forest, MeshData
from .ops import physics
from .ops.constraints import (Constraints, hanging_interpolate_p,
                              hanging_interpolate_u, make_constraints)
from .output import PvdWriter, write_vtu
from .profiling import Timer, memory_stats
from .solvers import newton
from .solvers.newton import NoConvergence
from .statistics import Statistics

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_DIR = os.environ.get("CRACKS_TPU_MESH_DIR",
                          os.path.join(REPO_ROOT, "meshes"))


@dataclass
class SolutionState:
    u: jnp.ndarray
    phi: jnp.ndarray
    u_old: jnp.ndarray
    phi_old: jnp.ndarray
    phi_oold: jnp.ndarray
    last_log: object = None
    active_mask: object = None  # PDAS active set of the last solve


class System:
    """Everything bound to one mesh epoch: geometry tables, constraints,
    material fields, physics scalars (refreshed per solve context)."""

    def __init__(self, params: Parameters, mesh: MeshData,
                 bitmap: problems.BitmapField | None):
        self.params = params
        self.mesh = mesh
        self.dim = mesh.dim
        self.monolithic = params.outer_solver == "simple monolithic"
        lam, mu = problems.cell_lame_fields(params, mesh, bitmap)
        self.lam_cells = lam
        self.mu_cells = mu
        dtype = jnp.float64 if params.dtype == "float64" else jnp.float32
        self.dtype = dtype
        # chunk-major scan layout only on the single-chip path: the SPMD
        # path shards the cell axis itself (parallel/sharding.py)
        one_chip = params.n_devices == 1
        # device-resident geometry core, built/uploaded ONCE per mesh
        # epoch; the f64 ca and the lattice raster-ordered f32/f64
        # variants derive from it on device (one dispatch each).  On a
        # device mesh the core itself is sharded along the cell axis —
        # it is the largest per-epoch object and must not stay
        # replicated (parallel/sharding.shard_cell_core).
        self._core = physics.build_cell_core(mesh, lam, mu)
        if params.n_devices > 1:
            from .parallel import sharding as _sh0
            self._core = _sh0.shard_cell_core(
                self._core, _sh0.make_device_mesh(params.n_devices,
                                                  dcn=params.mesh_dcn))
        self.ca = physics.cell_arrays_from_core(self._core, dtype=dtype,
                                                chunk=one_chip)
        # mixed-precision flag; the f32 cell arrays themselves are built
        # lazily (the lattice fast path carries its own raster-ordered
        # f32 arrays and never touches ca32 — at refine-6 sizes the
        # eager build cost minutes of host/transfer time)
        self.mixed_precision = (params.mixed_precision_cg
                                and dtype == jnp.float64)
        self._ca32 = None
        if params.n_devices > 1:
            # SPMD domain decomposition: shard the element arrays over the
            # device mesh; XLA's partitioner parallelizes the jitted
            # kernels and inserts the collectives (the explicit
            # shard_map formulation lives in parallel/sharding.py).
            from .parallel import sharding as _sh
            self._device_mesh = _sh.make_device_mesh(
                params.n_devices, dcn=params.mesh_dcn)
            self.ca = _sh.shard_cell_arrays(self.ca, self._device_mesh)
        else:
            self._device_mesh = None
        t = element_tables(mesh.dim)
        self.diag_mass = jnp.asarray(lumped_mass_diag(
            mesh.cell_coords, mesh.cell2vert, mesh.n_vertices, t), dtype=dtype)
        mask_u, _, mask_p, _ = problems.dirichlet_conditions(
            params, mesh, 0.0, initial_step=False)
        self._con = make_constraints(mesh, mask_u, mask_p, dtype=dtype)
        # GMG hierarchies (attached by the driver when preconditioner=gmg)
        self.hierarchy = None
        self.galerkin_hierarchy = None
        self.lattice_hierarchy = None
        self.lattice_ca32 = None
        self._lattice_lay = None
        self._lattice_ca64 = None
        # sharded-DoF halo-pool mode (solvers/halo_newton) — general
        # meshes (hanging nodes) when the lattice fast path is absent
        self.halo_partition = None
        self.halo_galerkin_hierarchy = None
        self._halo_heads = None
        self.use_halo_state = False
        # context (set by the driver before each nonlinear solve)
        self.scalars: physics.Scalars = None
        self.with_split: bool = False
        # mesh-dependent regularization (set by the driver)
        self.constant_k = 0.0
        self.alpha_eps = 0.0

    @property
    def lattice_ca64(self):
        """Lazily built f64 raster-ordered cell arrays — source of the
        exact stored-f64 element matrices used by the split-dispatch
        lattice solve's refinement operator (lattice._prepare64)."""
        if self._lattice_ca64 is None and self._lattice_lay is not None:
            from .solvers import lattice
            caL = physics.cell_arrays_from_core(
                self._core, dtype=jnp.float64,
                chunk=self.params.n_devices == 1,
                perm=self._lattice_lay.cell_perm)
            if self._device_mesh is not None:
                from .parallel import sharding as _sh
                caL = _sh.shard_cell_arrays_nopad(caL, self._device_mesh)
            self._lattice_ca64 = caL
        return self._lattice_ca64

    @property
    def ca32(self):
        """Lazily built f32 cell arrays for the mixed-precision
        Krylov paths (None when mixed precision is off)."""
        if not self.mixed_precision:
            return None
        if self._ca32 is None:
            self._ca32 = physics.cell_arrays_from_core(
                self._core, dtype=jnp.float32,
                chunk=self.params.n_devices == 1)
        return self._ca32

    # -- sharded-DoF (lattice) layout helpers (solvers/lattice_newton) --
    @property
    def lat_gyp(self) -> int:
        """Padded leading-grid-axis extent for boundary-crossing lattice
        vectors: ceil(GY/D)*D so the slab NamedSharding divides evenly
        (GY itself is odd)."""
        gy = self.lattice_hierarchy.grid[0]
        if self._device_mesh is None:
            return gy
        d = int(self._device_mesh.devices.size)
        return -(-gy // d) * d

    def lat_ns(self):
        """NamedSharding of a (k, gyp, ...) padded lattice vector:
        contiguous row slabs over the device mesh (None single-chip)."""
        if self._device_mesh is None:
            return None
        from jax.sharding import NamedSharding, PartitionSpec as P
        from .parallel.sharding import cell_axis
        return NamedSharding(
            self._device_mesh,
            P(None, cell_axis(self._device_mesh),
              *([None] * (self.dim - 1))))

    def lat_ns_jac(self):
        """NamedSharding of an (ndl, ndl, *cellgrid) element-matrix
        level: row slabs along the leading cell-grid axis."""
        if self._device_mesh is None:
            return None
        from jax.sharding import NamedSharding, PartitionSpec as P
        from .parallel.sharding import cell_axis
        return NamedSharding(
            self._device_mesh,
            P(None, None, cell_axis(self._device_mesh),
              *([None] * (self.dim - 1))))

    def constraints(self, time: float) -> Constraints:
        # masks are time-independent; Newton-update constraints are
        # homogeneous, so the same object serves all times
        return self._con

    def apply_initial_bc(self, u, phi, time: float):
        """set_initial_bc (cracks.cc:2699-2707): write the inhomogeneous
        boundary values into the (flat) solution."""
        mask_u, vals_u, mask_p, vals_p = problems.dirichlet_conditions(
            self.params, self.mesh, time, initial_step=True)
        u = jnp.where(jnp.asarray(mask_u.reshape(-1)),
                      jnp.asarray(vals_u.reshape(-1), dtype=u.dtype), u)
        phi = jnp.where(jnp.asarray(mask_p),
                        jnp.asarray(vals_p, dtype=phi.dtype), phi)
        return u, phi

    def set_context(self, *, time, timestep, old_timestep, old_old_timestep,
                    use_old_timestep_pf, timestep_number):
        p = self.params
        pressure = p.pressure(time=time)
        gamma = p.effective_gamma_penal
        if self.monolithic and timestep_number < 1:
            gamma = 0.0  # cracks.cc:2141-2144
        theta = (old_timestep + old_old_timestep) / old_old_timestep
        self.scalars = physics.make_scalars(
            pressure=pressure, constant_k=self.constant_k,
            alpha_eps=self.alpha_eps, G_c=p.G_c,
            gamma_dt=gamma / timestep, theta=theta,
            use_old_pf=1.0 if use_old_timestep_pf else 0.0,
            decompose_rhs=p.decompose_stress_rhs, dtype=self.dtype)
        self.with_split = (self.dim == 2 and p.decompose_stress_matrix > 0
                           and timestep_number > 0)


def _setup_coarse_mesh(p: Parameters) -> meshio.CoarseMesh:
    """setup_mesh (cracks.cc:1194-1303)."""
    case = p.test_case
    mesh_dir = MESH_DIR
    if case in ("miehe tension", "miehe shear"):
        return meshio.read_ucd(os.path.join(mesh_dir, "unit_slit.inp"), dim=2)
    if case == "sneddon":
        # root subdivisions: 10 per axis like the reference
        # (cracks.cc:1207-1212); overridable for benchmarking odd sizes
        reps = int(os.environ.get("CRACKS_TPU_SNEDDON_REPS", "10"))
        if p.dimension == 2:
            return meshio.rect_mesh([-10, -10], [10, 10], [reps, reps])
        return meshio.rect_mesh([-10, -10, -10], [10, 10, 10],
                                [reps, reps, reps])
    if case in ("multiple homo", "multiple het"):
        if p.dimension == 2:
            return meshio.read_ucd(os.path.join(mesh_dir, "unit_square_4.inp"), dim=2)
        return meshio.read_ucd(os.path.join(mesh_dir, "unit_cube_10.inp"), dim=3)
    if case == "three point bending":
        m = meshio.read_msh(os.path.join(mesh_dir, "threepoint.msh"), dim=2)
        return problems.recolor_threepoint_boundaries(m)
    raise NotImplementedError(case)


class Simulation:
    """The L6/L7 driver object (FracturePhaseFieldProblem analogue)."""

    def __init__(self, params: Parameters, verbose: bool = True):
        self.p = params
        self.verbose = verbose
        self.statistics = Statistics()
        self.timer = Timer()
        self.coarse = _setup_coarse_mesh(params)
        self.forest = Forest(self.coarse)
        self.forest.refine_global(params.n_global_pre_refine)
        self.bitmap = None
        if params.test_case == "multiple het":
            pgm = os.environ.get("CRACKS_TPU_PGM",
                                 os.path.join(REPO_ROOT, "test.pgm"))
            self.bitmap = problems.BitmapField(
                pgm, 0, 10, 0, 10, params.E_modulus, 10.0 * params.E_modulus)
        self.mesh: MeshData = self.forest.extract()
        self.sys: System = None
        self.min_cell_diameter = 0.0
        self.constant_k = 0.0
        self.alpha_eps = 0.0
        self.time = 0.0
        self.timestep = params.timestep_size
        self.timestep_number = 0
        self.old_timestep = self.timestep
        self.old_old_timestep = self.timestep
        self.use_old_timestep_pf = False
        self.output_counter = -1
        self.pvd = None
        if params.output_dir:
            os.makedirs(params.output_dir, exist_ok=True)
            with open(os.path.join(params.output_dir, "parameters.prm"), "w") as f:
                f.write(dump_parameters(params))
            self.pvd = PvdWriter(params.output_dir)
        # coarse max diameter for the h-prediction formula
        coarse_coords = self.coarse.vertices[self.coarse.cells]
        d = coarse_coords[:, :, None, :] - coarse_coords[:, None, :, :]
        self.coarse_max_diameter = float(
            np.sqrt((d ** 2).sum(-1)).max())

    # ------------------------------------------------------------------
    def log(self, *args):
        if self.verbose:
            print(*args)

    def setup_system(self):
        _t0 = walltime.time()
        self.sys = System(self.p, self.mesh, self.bitmap)
        self.sys.constant_k = self.constant_k
        self.sys.alpha_eps = self.alpha_eps
        if self.p.preconditioner == "gmg":
            p = self.p

            def lam_fn(m):
                return problems.cell_lame_fields(p, m, self.bitmap)

            def dirichlet_fn(m):
                mu_, _, mp_, _ = problems.dirichlet_conditions(
                    p, m, 0.0, initial_step=False)
                return mu_, mp_

            if p.assembled_matvec and self.sys.mixed_precision:
                # tensor-grid (monolattice) fast path: gather-free
                # Krylov loop on uniformly refined rect/cube meshes
                # (solvers/lattice.py), 2d and 3d.  Multi-chip runs
                # shard the cell axis over the device mesh and let
                # GSPMD partition the lattice solve (slice-shift
                # patterns become halo exchanges between devices).
                from .solvers import lattice
                lay = lattice.detect_tensor_grid(self.mesh)
                if lay is not None:
                    hier = lattice.build_lattice_hierarchy(
                        self.mesh, lay, dirichlet_fn)
                    if hier is not None:
                        self.sys.lattice_hierarchy = hier
                        self.sys._lattice_lay = lay
                        caL = physics.cell_arrays_from_core(
                            self.sys._core, dtype=jnp.float32,
                            chunk=(p.n_devices == 1),
                            perm=lay.cell_perm)
                        if self.sys._device_mesh is not None:
                            from .parallel import sharding as _sh
                            caL = _sh.shard_cell_arrays_nopad(
                                caL, self.sys._device_mesh)
                        self.sys.lattice_ca32 = caL
            if (p.assembled_matvec
                    and getattr(self.sys, "lattice_hierarchy",
                                None) is None):
                # coefficient-exact Galerkin element coarsening
                # (solvers/galerkin.py); falls back below when the mesh
                # has hanging nodes on any level
                from .solvers import galerkin
                self.sys.galerkin_hierarchy = galerkin.\
                    build_galerkin_hierarchy(self.forest, self.mesh,
                                             dirichlet_fn)
            if (getattr(self.sys, "galerkin_hierarchy", None) is None
                    and getattr(self.sys, "lattice_hierarchy",
                                None) is None):
                from .solvers import multigrid
                self.sys.hierarchy = multigrid.build_hierarchy(
                    self.forest, self.mesh, p, lam_fn, dirichlet_fn,
                    dtype=self.sys.dtype)
        # sharded-DoF production mode (solvers/lattice_newton.py):
        # lattice-layout state, slab-sharded over the device mesh.
        # Seam (slit) lattices are supported: the duplication-map
        # conjugation S^T . S is threaded through the sharded heads
        # and the split solve (matmul-form seam ops partition under
        # GSPMD).
        self.sys.use_lattice_state = (
            self.p.dof_sharding == "lattice"
            and getattr(self.sys, "lattice_hierarchy", None) is not None
            and self.p.outer_solver == "active set")
        if (self.p.dof_sharding == "lattice"
                and not self.sys.use_lattice_state
                and self.p.outer_solver == "active set"
                and self.sys._device_mesh is not None):
            # general-mesh sharded-DoF fallback: owned+ghost halo pool
            # (hanging nodes supported) — the reference distributes
            # every mesh type (cracks.cc:1622-1628)
            from .parallel.halo import build_halo_partition
            from .parallel.sharding import cell_axis  # noqa: F401
            n_shards = int(self.sys._device_mesh.devices.size)
            part = build_halo_partition(
                self.mesh, self.sys.lam_cells, self.sys.mu_cells,
                n_shards)
            from .parallel.halo import device_put_partition
            self.sys.halo_partition = device_put_partition(
                part, self.sys._device_mesh)
            self.sys.use_halo_state = True
            if self.p.preconditioner == "gmg":
                from .solvers import halo_galerkin
                self.sys.halo_galerkin_hierarchy = (
                    halo_galerkin.build_pooled_hierarchy(
                        self.forest, self.mesh, self.sys,
                        self.sys.halo_partition))
            self.log("DoF sharding = lattice: no tensor-grid fast "
                     "path on this mesh; engaging the owned+ghost "
                     "halo-pool sharded mode")
        elif (self.p.dof_sharding == "lattice"
                and not self.sys.use_lattice_state):
            self.log("DoF sharding = lattice requested but unavailable "
                     "(needs the active-set solver and a multi-device "
                     "mesh); falling back to replicated DoF vectors")
        if os.environ.get("CRACKS_TPU_STEP_LOG") == "1":
            kind = ("lattice" if getattr(self.sys, "lattice_hierarchy",
                                         None) is not None
                    else "galerkin" if getattr(self.sys,
                                               "galerkin_hierarchy",
                                               None) is not None
                    else "generic")
            print(f"# setup_system dofs={self.mesh.n_dofs} "
                  f"cells={self.mesh.n_cells} path={kind} "
                  f"wall={walltime.time() - _t0:.1f}s",
                  file=sys.stderr, flush=True)
        self.log(f"\nDoFs: {self.mesh.n_vertices * self.mesh.dim} solid + "
                 f"{self.mesh.n_vertices} phase = {self.mesh.n_dofs}")

    def determine_mesh_dependent_parameters(self):
        """cracks.cc:3820-3892."""
        p = self.p
        h = self.mesh.min_cell_diameter
        if p.test_case in ("miehe tension", "miehe shear", "multiple homo",
                           "three point bending"):
            h = self.coarse_max_diameter * 2.0 ** (
                -(p.n_global_pre_refine + p.n_refinement_cycles
                  + p.n_local_pre_refine))
        self.min_cell_diameter = h
        self.constant_k = p.k_reg(h)
        self.alpha_eps = p.eps_reg(h)
        if self.sys is not None:
            self.sys.constant_k = self.constant_k
            self.sys.alpha_eps = self.alpha_eps

    # ------------------------------------------------------------------
    # refinement
    # ------------------------------------------------------------------
    def _refine_flags(self, state: SolutionState) -> np.ndarray:
        """Strategy dispatch (cracks.cc:3902-4103)."""
        p = self.p
        mesh = self.mesh
        n_c = mesh.n_cells
        flags = np.zeros(n_c, dtype=bool)
        strat = p.ref_strategy
        phi = np.asarray(state.phi)

        def box_flag(x0, x1, y0, y1):
            vc = mesh.cell_coords
            inside = ((vc[..., 0] >= x0) & (vc[..., 0] <= x1)
                      & (vc[..., 1] >= y0) & (vc[..., 1] <= y1))
            return inside.any(axis=1)

        if strat == "fixed preref sneddon":
            flags = box_flag(-2.5, 2.5, -1.25, 1.25)
        elif strat == "fixed preref miehe tension":
            flags = box_flag(0.0, 0.6, 0.45, 0.55)
        elif strat == "fixed preref miehe shear":
            flags = box_flag(0.0, 0.6, 0.0, 0.55)
        elif strat in ("fixed preref multiple homo", "fixed preref multiple het"):
            # the reference declares these strategy names but implements no
            # dedicated flagging for them (cracks.cc:3902-4103) — no-op
            pass
        elif strat == "phase field":
            pf_cell = phi[mesh.cell2vert]
            flags = (pf_cell < p.value_phase_field_for_refinement).any(axis=1)
        elif strat == "phase field three point top":
            pf_cell = phi[mesh.cell2vert]
            flags = (pf_cell < p.value_phase_field_for_refinement).any(axis=1)
            flags |= (mesh.cell_coords[..., 1] >= 1.75).any(axis=1)
        elif strat == "global":
            flags[:] = True
        elif strat == "mix":
            pf_cell = phi[mesh.cell2vert]
            flags = (pf_cell < p.value_phase_field_for_refinement).any(axis=1)
            eta = self._kelly_estimator(state)
            eta[flags] = 0.0
            n_refine = int(0.3 * n_c)
            if n_refine > 0:
                thresh = np.partition(eta, -n_refine)[-n_refine]
                flags |= (eta >= thresh) & (eta > 0)
        else:
            raise NotImplementedError(strat)

        # level cap (cracks.cc:4107-4116)
        if p.test_case != "sneddon":
            cap = (p.n_global_pre_refine + p.n_refinement_cycles
                   + p.n_local_pre_refine)
            flags &= self.forest.level != cap
        return flags

    def _kelly_estimator(self, state: SolutionState) -> np.ndarray:
        """Kelly face-jump error indicator on the displacement components
        (cracks.cc:4070-4083): exact deal.II KellyErrorEstimator analogue
        with per-face normal-gradient jump integrals (kelly.py)."""
        from .kelly import kelly_estimate
        return kelly_estimate(self.mesh, np.asarray(state.u))

    def refine_mesh(self, state: SolutionState) -> bool:
        """refine_mesh (cracks.cc:3895-4163): flag, balance, execute,
        transfer {solution, old, old_old}, re-setup."""
        flags = self._refine_flags(state)
        if not flags.any():
            # No-op detection (cracks.cc:4118-4135 reduces any-flags over
            # ranks; single-controller here, so a plain any()).  Early
            # return is sound because balancing is CLOSED over no-ops:
            # the forest is 2:1-balanced after every refine_and_transfer
            # (mesh.Forest balances before extraction), and a balanced
            # forest with zero new flags stays balanced — balance can
            # only induce work downstream of at least one genuine flag.
            # The invariant is executable, not assumed: balance_flags on
            # an all-False vector must be a fixed point.  Checked once
            # per mesh epoch (the forest is unchanged between epochs, so
            # re-checking every step would be pure overhead).
            if not getattr(self, "_balance_checked", False):
                assert not self.forest.balance_flags(flags).any(), \
                    "forest not 2:1-balanced on entry to refine_mesh"
                self._balance_checked = True
            return False
        dim = self.mesh.dim
        fields = [np.asarray(state.u).reshape(-1, dim), np.asarray(state.phi),
                  np.asarray(state.u_old).reshape(-1, dim),
                  np.asarray(state.phi_old), np.asarray(state.phi_oold)]
        new_mesh, new_fields, nref = self.forest.refine_and_transfer(
            flags, self.mesh, fields)
        if nref == 0:
            return False
        self.mesh = new_mesh
        self._balance_checked = False
        state.u = jnp.asarray(new_fields[0].reshape(-1))
        state.phi = jnp.asarray(new_fields[1])
        state.u_old = jnp.asarray(new_fields[2].reshape(-1))
        state.phi_old = jnp.asarray(new_fields[3])
        state.phi_oold = jnp.asarray(new_fields[4])
        self.setup_system()
        self.determine_mesh_dependent_parameters()
        return True

    # ------------------------------------------------------------------
    def interpolate_initial_values(self, state: SolutionState):
        u0, phi0 = problems.initial_values(self.p, self.mesh,
                                           self.min_cell_diameter)
        state.u = jnp.asarray(u0.reshape(-1))
        state.phi = jnp.asarray(phi0)

    def project_back_phase_field(self, state: SolutionState):
        state.phi = jnp.clip(state.phi, 0.0, 1.0)

    def output_results(self, state: SolutionState):
        if self.pvd is None or not self.p.write_vtu:
            return
        self.output_counter += 1
        name = (f"{self.p.output_filename}"
                f"{self.output_counter:05d}.vtu")
        point_data = {"displacement": np.asarray(state.u).reshape(-1, self.mesh.dim),
                      "phasefield": np.asarray(state.phi)}
        # VTU parity fields (cracks.cc:3142-3258): Sneddon exact-phi
        # postprocessor, active-set mask, owner subdomain
        if self.p.test_case == "sneddon":
            point_data["exact_phi"] = qoi.sneddon_exact_phi(
                self.mesh.vert_coords, self.alpha_eps)
        if getattr(state, "active_mask", None) is not None \
                and len(state.active_mask) == self.mesh.n_vertices:
            point_data["active_set"] = np.asarray(
                state.active_mask, dtype=float)
        cell_data = {"level": self.mesh.cell_level.astype(float)}
        n_c = self.mesh.n_cells
        cell_data["subdomain"] = (np.arange(n_c) * self.p.n_devices
                                  // max(n_c, 1)).astype(float)
        if self.p.test_case == "multiple het":
            centers = self.mesh.cell_coords.mean(axis=1)
            cell_data["emodulus"] = 1.0 + self.bitmap.value(centers)
        write_vtu(os.path.join(self.p.output_dir, name), self.mesh,
                  point_data, cell_data)
        self.pvd.add(self.time, name)

    # ------------------------------------------------------------------
    def run(self, resume_state: SolutionState | None = None):
        """The timestep loop (cracks.cc:4166-4581).

        With resume_state given (a SolutionState from
        checkpoint.load_checkpoint, whose loader already restored the
        forest, System and time-stepping fields), initialization —
        pre-refinement, initial values, old-solution seeding — is
        skipped and the loop continues from the checkpointed step.
        The Sneddon refinement-cycle countdown is carried in the
        checkpoint meta, so a resumed run continues the remaining
        cycles instead of re-running the prm value from scratch."""
        p = self.p
        t_start = walltime.time()
        self.log(f"Cells:\t{self.mesh.n_cells}")

        if resume_state is None:
            with self.timer.section("Setup system"):
                self.setup_system()
            self.determine_mesh_dependent_parameters()

            n_v = self.mesh.n_vertices
            zero_u = jnp.zeros(n_v * self.mesh.dim)
            state = SolutionState(u=zero_u, phi=jnp.zeros(n_v),
                                  u_old=zero_u, phi_old=jnp.zeros(n_v),
                                  phi_oold=jnp.zeros(n_v))

            # local pre-refinement (cracks.cc:4177-4211)
            for _ in range(p.n_local_pre_refine):
                self.log(f"Prerefinement step with h= "
                         f"{self.min_cell_diameter}")
                self.interpolate_initial_values(state)
                state.u_old = state.u
                state.phi_old = state.phi
                state.phi_oold = state.phi
                self.refine_mesh(state)

            if p.n_local_pre_refine == 0:
                self.determine_mesh_dependent_parameters()
        else:
            state = resume_state
        if self.sys is None:
            with self.timer.section("Setup system"):
                self.setup_system()

        # sanity checks mirroring the reference (cracks.cc:4216-4217)
        if not (self.alpha_eps >= self.min_cell_diameter):
            raise ValueError("You need to pick eps >= h")
        if not (self.constant_k < 1.0):
            raise ValueError("You need to pick K < 1")

        self.log(f"\nParameters\n==========\n"
                 f"h (min):           {self.min_cell_diameter}\n"
                 f"k:                 {self.constant_k}\n"
                 f"eps:               {self.alpha_eps}\n"
                 f"G_c:               {p.G_c}\n")

        if resume_state is None:
            with self.timer.section("Initial values + output"):
                self.interpolate_initial_values(state)
                self.output_results(state)
                self.project_back_phase_field(state)

            state.phi_old = state.phi
            state.phi_oold = state.phi
            state.u_old = state.u

            self.old_timestep = self.timestep
            self.old_old_timestep = self.timestep

        # refinement-cycle countdown: persistent attributes so the
        # checkpoint can carry them (a resumed run must continue the
        # countdown, not restart it)
        if getattr(self, "refinement_cycle", None) is None:
            self.refinement_cycle = 0
        if getattr(self, "refinement_cycles_left", None) is None:
            self.refinement_cycles_left = p.n_refinement_cycles
        finishing_timestep_loop = 0.0
        # per-step solver effort (timestep_number, newton_its, linear_its)
        # — the reference prints these in its Newton trace and they are
        # its preconditioner-quality metric (tests/*.output #LinIts)
        self.solver_effort = []
        # per-step wall clock (timestep_number, n_dofs, seconds) — the
        # bench's per-mesh-epoch timing source (adaptive runs change
        # DoF counts mid-run, so a single wall/steps average would mix
        # mesh sizes)
        self.step_times = []

        def solver(sys_, state_, time_, verbose=True):
            if p.outer_solver != "active set":
                return newton.newton_iteration(sys_, state_, time_,
                                               verbose=verbose)
            if getattr(sys_, "use_lattice_state", False):
                from .solvers.lattice_newton import newton_active_set_lattice
                return newton_active_set_lattice(sys_, state_, time_,
                                                 verbose=verbose)
            if getattr(sys_, "use_halo_state", False):
                from .solvers.halo_newton import newton_active_set_halo
                return newton_active_set_halo(sys_, state_, time_,
                                              verbose=verbose)
            return newton.newton_active_set(sys_, state_, time_,
                                            verbose=verbose)

        if (resume_state is not None
                and self.timestep_number > p.max_no_timesteps):
            self.log("Checkpoint is already past Max No of timesteps")
            self._last_state = state
            return state

        # ---- timestep loop ----
        while True:
            step_t0 = walltime.time()
            if self.timestep_number > p.switch_timestep and p.switch_timestep > 0:
                self.timestep = p.timestep_size_2

            tmp_timestep = self.timestep
            self.old_old_timestep = self.old_timestep
            self.old_timestep = self.timestep

            state.phi_oold = state.phi_old
            state.phi_old = state.phi
            state.u_old = state.u

            redo = True
            while redo:  # redo_step (cracks.cc:4305)
                redo = False
                self.log(f"\nTimestep {self.timestep_number}: {self.time} "
                         f"({self.timestep})   Cells: {self.mesh.n_cells}   "
                         f"DoFs: {self.mesh.n_dofs}\n")

                if p.outer_solver == "active set":
                    self.time += self.timestep
                    while True:
                        self.use_old_timestep_pf = False
                        try:
                            self._set_context()
                            solver(self.sys, state, self.time,
                                   verbose=self.verbose)
                            break
                        except NoConvergence:
                            self.log(f"Solver did not converge! Adjusting "
                                     f"time step to {self.timestep / 10}")
                        self.log("Taking old_timestep_pf")
                        self.use_old_timestep_pf = True
                        state.u = state.u_old
                        state.phi = state.phi_old
                        if p.test_case == "three point bending":
                            self._set_context()
                            solver(self.sys, state, self.time,
                                   verbose=self.verbose)
                            break
                        self.time -= self.timestep
                        self.timestep /= 10.0
                        self.time += self.timestep
                else:  # simple monolithic (cracks.cc:4360-4410)
                    self.time += self.timestep
                    while True:
                        self.use_old_timestep_pf = False
                        try:
                            self.project_back_phase_field(state)
                            self._set_context()
                            reduction = solver(self.sys, state, self.time,
                                               verbose=self.verbose)
                            while reduction > p.upper_newton_rho:
                                self.use_old_timestep_pf = True
                                self.time -= self.timestep
                                self.timestep /= 10.0
                                self.time += self.timestep
                                state.u = state.u_old
                                state.phi = state.phi_old
                                self._set_context()
                                reduction = solver(self.sys, state, self.time,
                                                   verbose=self.verbose)
                                if self.timestep < 1e-9:
                                    self.log("Timestep too small - taking step")
                                    break
                            break
                        except NoConvergence:
                            self.log("Solver did not converge! Adjusting time step.")
                        self.time -= self.timestep
                        state.u = state.u_old
                        state.phi = state.phi_old
                        self.timestep /= 10.0
                        self.time += self.timestep

                log = getattr(state, "last_log", None)
                if log is not None:
                    self.solver_effort.append(
                        (self.timestep_number,
                         getattr(log, "newton_steps", 0),
                         getattr(log, "linear_iterations", 0)))

                self.project_back_phase_field(state)
                con = self.sys.constraints(self.time)
                state.u = hanging_interpolate_u(state.u, con)
                state.phi = hanging_interpolate_p(state.phi, con)

                if p.test_case != "sneddon":
                    if self.refine_mesh(state):
                        self.log("MESH CHANGED!")
                        self.time -= self.timestep
                        state.u = state.u_old
                        state.phi = state.phi_old
                        redo = True

            self.timestep = tmp_timestep

            # ---- statistics (cracks.cc:4436-4459) ----
            st = self.statistics
            st.add_value("Timestep No", int(self.timestep_number))
            st.add_value("Time", float(self.time))
            st.add_value("DoFs", int(self.mesh.n_dofs))
            st.add_value("minimum cell diameter", self.min_cell_diameter)
            st.set_scientific("minimum cell diameter", 8)

            bulk_d, crack_d, tcv_d = qoi.energy_tcv_device(
                state.u, state.phi, self.sys.ca, *self._energy_lam_mu_dev(),
                self.constant_k, self.alpha_eps, p.G_c, dim=self.mesh.dim)
            bulk, crack = float(bulk_d), float(crack_d)
            self.log(f"No {self.timestep_number} time {self.time} "
                     f"bulk energy: {bulk} crack energy: {crack}")
            st.add_value("Bulk Energy", bulk)
            st.set_scientific("Bulk Energy", 8)
            st.add_value("Crack Energy", crack)
            st.set_scientific("Crack Energy", 8)

            if p.test_case in ("miehe tension", "miehe shear",
                               "three point bending"):
                load = qoi.compute_load(self.mesh, self._u_mat(state),
                                        self.sys.lam_cells, self.sys.mu_cells)
                if p.test_case == "miehe tension":
                    st.add_value("Load y", float(load[1]))
                    st.set_scientific("Load y", 8)
                    self.log(f"  Load y: {load[1]}")
                elif p.test_case == "miehe shear":
                    st.add_value("Load x", float(load[0]))
                    st.set_scientific("Load x", 8)
                    self.log(f"  Load x: {load[0]}")
                else:
                    st.add_value("Load P11", float(-load[1]))
                    st.set_scientific("Load P11", 8)
                    ps = qoi.compute_point_stress(self.mesh, self._u_mat(state))
                    self.log(f" PStress: {ps}  P11: {-load[1]}")

            self.output_results(state)
            if p.output_dir:
                st.write(os.path.join(p.output_dir, "statistics"))

            finishing_timestep_loop = float(qoi.linf_diff_device(
                state.u, state.u_old, state.phi, state.phi_old))
            if p.test_case == "sneddon":
                self.log(f"Timestep difference linfty: {finishing_timestep_loop}")

            self.timer.wall["Time step loop"] += walltime.time() - step_t0
            self.timer.calls["Time step loop"] += 1
            self.step_times.append((self.timestep_number,
                                    self.mesh.n_dofs,
                                    walltime.time() - step_t0))
            if os.environ.get("CRACKS_TPU_STEP_LOG") == "1":
                # progress heartbeat for long benched trajectories: a
                # killed run still leaves per-step timings in the log
                print(f"# step {self.timestep_number} time={self.time:g} "
                      f"dofs={self.mesh.n_dofs} "
                      f"wall={self.step_times[-1][2]:.1f}s",
                      file=sys.stderr, flush=True)
            self.timestep_number += 1

            # ---- Sneddon stationarity (cracks.cc:4483-4560) ----
            if p.test_case == "sneddon" and finishing_timestep_loop < 1e-5:
                tcv = float(tcv_d)
                ref = qoi.tcv_exact(self.mesh.dim, p.pressure(time=self.time),
                                    p.poisson_ratio_nu)
                self.log(f"TCV: value= {tcv} exact= {ref} "
                         f"error= {abs(tcv - ref)}")
                st.add_value("TCV", tcv)
                st.set_scientific("TCV", 8)
                self._write_cod_array(state)
                self._write_cod_profile(state)
                l2err = qoi.sneddon_phi_l2_error(
                    self.mesh, np.asarray(state.phi), self.alpha_eps)
                self.log(f"phi_L2_error: {l2err} h: {self.min_cell_diameter}")
                st.add_value("phi_L2_error", l2err)
                st.set_scientific("phi_L2_error", 8)

                if self.refinement_cycles_left == 0:
                    break
                self.refinement_cycles_left -= 1
                self.log(f"\n==================\nRefinement cycle "
                         f"{self.refinement_cycle}\n------------------")
                self.refine_mesh(state)
                self.refinement_cycle += 1
                self.interpolate_initial_values(state)

            # periodic checkpoint (new capability over the reference,
            # SURVEY section 5): one rolling restartable snapshot.
            # Taken AFTER the stationarity block so a snapshot reflects
            # any refinement cycle this step triggered (mesh + the
            # remaining-cycle countdown) — a resumed run continues
            # exactly where the uninterrupted run would.
            if (p.checkpoint_every > 0 and p.output_dir
                    and self.timestep_number % p.checkpoint_every == 0):
                from .checkpoint import save_checkpoint
                save_checkpoint(
                    os.path.join(p.output_dir, "checkpoint.npz"),
                    self, state)

            if self.timestep_number > p.max_no_timesteps:
                break

        self.log(f"\nFinishing time step loop: {finishing_timestep_loop}")
        if self.verbose:
            print(self.timer.summary())
            print(memory_stats())
        self.log(f"Total wall time: {walltime.time() - t_start:.2f}s")
        self._last_state = state
        return state

    # ------------------------------------------------------------------
    def _u_mat(self, state) -> np.ndarray:
        return np.asarray(state.u).reshape(-1, self.mesh.dim)

    def _set_context(self):
        self.sys.set_context(
            time=self.time, timestep=self.timestep,
            old_timestep=self.old_timestep,
            old_old_timestep=self.old_old_timestep,
            use_old_timestep_pf=self.use_old_timestep_pf,
            timestep_number=self.timestep_number)

    def _energy_lam_mu_dev(self):
        """Device copies of the energy Lame fields, cached per mesh
        epoch (consumed by qoi.energy_tcv_device every time step)."""
        cache = getattr(self.sys, "_energy_lam_mu_dev", None)
        if cache is None:
            cache = (jnp.asarray(self._energy_lam(), jnp.float64),
                     jnp.asarray(self._energy_mu(), jnp.float64))
            self.sys._energy_lam_mu_dev = cache
        return cache

    def _energy_lam(self):
        """compute_energy uses the raw bitmap E (without the +1 offset
        the assembly applies) — reference quirk at cracks.cc:3651."""
        if self.p.test_case == "multiple het":
            centers = self.mesh.cell_coords.mean(axis=1)
            E = self.bitmap.value(centers)
            nu = self.p.poisson_ratio_nu
            mu = E / (2 * (1 + nu))
            return 2 * nu * mu / (1 - 2 * nu)
        return self.sys.lam_cells

    def _energy_mu(self):
        if self.p.test_case == "multiple het":
            centers = self.mesh.cell_coords.mean(axis=1)
            E = self.bitmap.value(centers)
            return E / (2 * (1 + self.p.poisson_ratio_nu))
        return self.sys.mu_cells

    def _write_cod_array(self, state: SolutionState):
        """compute_cod_array (cracks.cc:3339-3449): the 75-bucket COD
        profile vs the exact Sneddon opening 1.92e-3*sqrt(1-x^2),
        written to cod-NN.txt ("x value exact" per line) with the
        profile L2 error norm and the |COD(0) - 3.84e-4| middle error
        printed in the reference's format (cracks.cc:3427-3436).

        The reference ships this but leaves the call site commented out
        as "very expensive" (cracks.cc:4491); here the batched bucketed
        sweep is cheap enough to run at every Sneddon stationarity
        event whenever an output directory is configured."""
        if not self.p.output_dir or self.mesh.dim != 2:
            return
        u = self._u_mat(state)
        phi = np.asarray(state.phi)
        xs, vals, exact = qoi.compute_cod_array(self.mesh, u, phi)
        middle = qoi.compute_cod(self.mesh, u, phi, 0.0)
        path = os.path.join(self.p.output_dir,
                            f"cod-{self.timestep_number:02d}.txt")
        self.log(f"writing {os.path.basename(path)}")
        with open(path, "w") as f:
            for x, v, e in zip(xs, vals, exact):
                f.write(f"{x} {v} {e}\n")
        error = float(np.sqrt(np.sum((vals - exact) ** 2)))
        err_middle = abs(middle - 3.84e-4)
        self.log(f"ERROR: {error} alpha_eps: {self.alpha_eps} "
                 f"k: {self.constant_k} hmin: {self.min_cell_diameter} "
                 f"errmiddle: {err_middle} dofs: {self.mesh.n_dofs}")

    def _write_cod_profile(self, state: SolutionState):
        """compute_functional_values (cracks.cc:3704-3725): the full
        769-line COD sweep over x in [-1.5, 1.5] (one batched
        face-geometry pass, qoi.compute_cod_sweep)."""
        if not self.p.output_dir:
            return
        if self.mesh.dim != 2:
            return
        N = 16 * 16
        dx = 1.0 / N
        xs = -1.5 + np.arange(3 * N + 1) * dx
        vals = qoi.compute_cod_sweep(self.mesh, self._u_mat(state),
                                     np.asarray(state.phi), xs)
        path = os.path.join(self.p.output_dir,
                            f"cod-{self.timestep_number:02d}b.txt")
        with open(path, "w") as f:
            for x, v in zip(xs, vals):
                if v > -1e100:
                    f.write(f"{x} {v}\n")


def run_prm(path_or_text: str, **overrides):
    """CLI-style entry: run a .prm configuration end to end.

    With `Resume from` set ("TPU parameters" subsection), the run continues from
    the checkpoint instead of initial values."""
    from .config import load_parameters
    p = load_parameters(path_or_text, **overrides)
    if p.resume_from:
        from .checkpoint import load_checkpoint
        sim, state = load_checkpoint(p.resume_from, p, verbose=True)
        state = sim.run(state)
        return sim, state
    sim = Simulation(p)
    state = sim.run()
    return sim, state
