"""Smoke test of the main path on a GPU.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # the multi-device paths on four cards

One process drives the card through the entry points a user calls
(`driver.run_prm`, `driver.Simulation`).  Phases, in order:

1. device   — JAX's first device is a GPU; print the card's name and
               power limit as nvidia-smi reports them.
2. golden   — sneddon_2d_1 and the first 5 rows of miehe_shear_2
               against tests/golden at the tolerances stated below.
3. matvec   — the lattice stencil matvec at the refine-6 u- and p-block
               widths in f32 against a plain f64 stencil written
               without the lattice module.
4. oracle   — the refine-4 Sneddon load step (.claude/skills/verify)
               against its CPU bulk energy.
5. main     — one Sneddon 2d load step at refine 6 (1,232,643 DoFs)
               through Simulation: iterations, energies, compile and
               step seconds, executable memory.

--four runs only the multi-device phases: the refine-6 step on one
device, lattice-sharded on four and replicated on four, and the
halo-pool path on a hanging-node mesh against its replicated twin.

Any failure raises, so the process exits non-zero and never prints the
final line.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SNEDDON_PRM = os.path.join(HERE, "params", "parameters_sneddon_2d.prm")
SNEDDON_2D_DOFS_REFINE6 = 1_232_643

# The refine-4 oracle: one load step of the .claude/skills/verify
# command, with the bulk energy that command gives on the CPU backend
# (x86 host, JAX 0.9.0).  A GPU sums in another order (atomic
# scatter-adds, other reduction trees), and the solve stops at cg_rtol
# 1e-8 and Newton bound 1e-7, so 1e-6 relative is the stated bound.
ORACLE_OVERRIDES = dict(
    n_global_pre_refine=4, n_local_pre_refine=0, n_refinement_cycles=0,
    max_no_timesteps=0, linear_solver="cg", preconditioner="gmg",
    mixed_precision_cg=True, cg_rtol=1e-8, output_dir="")
ORACLE_BULK_ENERGY_CPU = 2.244925676779196e-06
ORACLE_RTOL = 1e-6

# golden tolerances: the reference's numdiff (abs 1e-6 OR rel 1e-8,
# tests/regression.py) for both tables; the GPU's order-dependent f64
# sums sit far below them at these sizes
GOLDEN_ATOL, GOLDEN_RTOL = 1e-6, 1e-8
MATVEC_RTOL = 1e-5          # relative 2-norm error, f32 at HIGHEST
PARITY_ATOL, PARITY_RTOL = 1e-6, 1e-8
# global refinement of the halo-pool phase (one local refinement on top:
# 86,271 DoFs): its Jacobi block-CG needs O(1/h) iterations, so it stays
# well below the lattice sizes
HALO_REFINE = 4


def _print(*a):
    print(*a, flush=True)


class _CompileClock:
    """Backend compile seconds and persistent-cache hits, from JAX's
    own monitoring events."""

    COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"
    CACHE_HIT_EVENT = "/jax/compilation_cache/cache_hits"

    def __init__(self):
        import jax.monitoring as mon
        self.seconds = 0.0
        self.count = 0
        self.cache_hits = 0

        def on_duration(event, duration, **_):
            if event == self.COMPILE_EVENT:
                self.seconds += duration
                self.count += 1

        def on_event(event, **_):
            if event == self.CACHE_HIT_EVENT:
                self.cache_hits += 1

        mon.register_event_duration_secs_listener(on_duration)
        mon.register_event_listener(on_event)

    def snapshot(self):
        return self.seconds, self.count, self.cache_hits


def phase_device(n_min):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {devs[0].platform}")
    if len(devs) < n_min:
        raise RuntimeError(f"need {n_min} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    _print(f"# device: platform={devs[0].platform} "
           f"kind={devs[0].device_kind} count={len(devs)}")
    _print(f"# card: {card}")
    return devs


def _sneddon(refine, **kw):
    from cracks_tpu.config import load_parameters
    ov = dict(ORACLE_OVERRIDES, n_global_pre_refine=refine)
    ov.update(kw)
    return load_parameters(SNEDDON_PRM, **ov)


def _quiet(fn, *a, **kw):
    """fn(*a, **kw) with its standard output (Newton traces, timer
    tables) discarded, so the smoke's own lines stay readable."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def phase_golden():
    import numpy as np

    from cracks_tpu.driver import run_prm
    from tests.regression import (PRM_DIR, compare_statistics,
                                  load_golden, parse_statistics)

    sim, _ = _quiet(run_prm, os.path.join(PRM_DIR, "sneddon_2d_1.prm"),
                    output_dir="")
    compare_statistics(sim.statistics.write_text(),
                       "sneddon_2d_1.statistics",
                       atol=GOLDEN_ATOL, rtol=GOLDEN_RTOL)
    _print(f"# golden sneddon_2d_1: match (abs {GOLDEN_ATOL:g} or rel "
           f"{GOLDEN_RTOL:g}); TCV {sim.statistics.data['TCV'][-1]!r}")
    sim, _ = _quiet(run_prm, os.path.join(PRM_DIR, "miehe_shear_2.prm"),
                    output_dir="", max_no_timesteps=4)
    o = parse_statistics(sim.statistics.write_text())[1][:5]
    g = load_golden("miehe_shear_2.statistics")[1][:5]
    if o.shape != g.shape:
        raise AssertionError(f"miehe_shear_2 rows {o.shape} vs {g.shape}")
    diff = np.abs(o - g)
    ok = (diff <= GOLDEN_ATOL) | (diff <= GOLDEN_RTOL * np.abs(g))
    if not ok.all():
        raise AssertionError(f"miehe_shear_2 rows 0-4 differ:\n{o}\n{g}")
    _print(f"# golden miehe_shear_2 rows 0-4: match (abs {GOLDEN_ATOL:g} "
           f"or rel {GOLDEN_RTOL:g}); max abs diff {diff.max():.3e}")


def _matvec_default_precision(jacL, X, lo, hi, k):
    """lattice.matvec_block at the backend's default f32 precision —
    only to put the TF32 effect on record."""
    import jax.numpy as jnp

    from cracks_tpu.solvers import lattice
    Xe = lattice.gather_windows(X)
    nvc = Xe.shape[0]
    Xf = Xe.reshape((nvc * k,) + Xe.shape[2:])
    Yf = jnp.einsum("ij...,j...->i...", jacL[lo:hi, lo:hi], Xf)
    return lattice.scatter_windows(Yf.reshape((nvc, k) + Yf.shape[1:]),
                                   X.shape[1:])


# (y, x) offset of Q1 corner a in a 2d cell: x = a & 1, y = a >> 1
# (the reference's lexicographic vertex order)
_CORNERS_2D = ((0, 0), (0, 1), (1, 0), (1, 1))


def _matvec_reference(jac, X, lo, hi, k):
    """Plain f64 stencil matvec of one 2d block, written without the
    lattice module: for every corner pair (a, b) and component pair
    (c, d), the cell products J[a*k+c, b*k+d] * X[d] over the window of
    corner b are added into Y[c] over the window of corner a."""
    import jax.numpy as jnp
    J = jac[lo:hi, lo:hi].astype(jnp.float64)
    X = X.astype(jnp.float64)
    cy, cx = J.shape[2:]
    Y = jnp.zeros(X.shape, jnp.float64)
    for a, (ay, ax) in enumerate(_CORNERS_2D):
        for c in range(k):
            acc = sum(J[a * k + c, b * k + d]
                      * X[d, by:by + cy, bx:bx + cx]
                      for b, (by, bx) in enumerate(_CORNERS_2D)
                      for d in range(k))
            Y = Y.at[c, ay:ay + cy, ax:ax + cx].add(acc)
    return Y


def phase_matvec(seed=0):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cracks_tpu.solvers import lattice
    gy = gx = 641                     # refine-6 vertex lattice
    key = jax.random.PRNGKey(seed)
    kj, kx = jax.random.split(key)
    jac = jax.random.normal(kj, (12, 12, gy - 1, gx - 1), jnp.float32)
    for which, (k, lo, hi) in (("u", (2, 0, 8)), ("p", (1, 8, 12))):
        X = jax.random.normal(kx, (k, gy, gx), jnp.float32)
        ref = jax.jit(_matvec_reference, static_argnums=(2, 3, 4))(
            jac, X, lo, hi, k)
        y = jax.jit(lattice.matvec, static_argnums=(2, 3, 4))(
            jac, X, lo, hi, k)
        y_def = jax.jit(_matvec_default_precision,
                        static_argnums=(2, 3, 4))(jac, X, lo, hi, k)
        rn = float(jnp.linalg.norm(ref))
        err = float(jnp.linalg.norm(y.astype(jnp.float64) - ref)) / rn
        err_def = float(jnp.linalg.norm(
            y_def.astype(jnp.float64) - ref)) / rn
        if not np.isfinite(err) or err > MATVEC_RTOL:
            raise AssertionError(f"{which}-block matvec error {err:.3e} "
                                 f"> {MATVEC_RTOL:g}")
        _print(f"# matvec {which}-block jac (12,12,{gy - 1},{gx - 1}) "
               f"X {tuple(X.shape)} vs plain f64 stencil: rel err "
               f"HIGHEST {err:.3e} (<= {MATVEC_RTOL:g}), default "
               f"precision {err_def:.3e}")


def phase_oracle():
    from cracks_tpu.driver import run_prm
    sim, _ = _quiet(run_prm, SNEDDON_PRM, **ORACLE_OVERRIDES)
    bulk = float(sim.statistics.data["Bulk Energy"][-1])
    rel = abs(bulk - ORACLE_BULK_ENERGY_CPU) / ORACLE_BULK_ENERGY_CPU
    _print(f"# oracle refine-4 ({sim.mesh.n_dofs} DoFs): bulk energy "
           f"{bulk!r} vs CPU {ORACLE_BULK_ENERGY_CPU!r}, rel {rel:.3e} "
           f"(<= {ORACLE_RTOL:g})")
    if not rel <= ORACLE_RTOL:
        raise AssertionError("refine-4 oracle outside its tolerance")


def _run_step(p):
    """One load step through Simulation; returns (sim, stats, wall
    seconds).  Raises unless Newton converged without a time-step cut
    and every value is finite."""
    import numpy as np

    from cracks_tpu import qoi
    from cracks_tpu.driver import Simulation
    sim = Simulation(p, verbose=False)
    t0 = time.perf_counter()
    state = sim.run()
    wall = time.perf_counter() - t0
    log = state.last_log
    if (log is None or log.newton_steps >= p.max_no_newton_steps
            or sim.timestep != p.timestep_size):
        raise AssertionError("Newton did not converge in the load step")
    u = np.asarray(state.u)
    phi = np.asarray(state.phi)
    for name, v in (("u", u), ("phi", phi)):
        if not np.isfinite(v).all():
            raise AssertionError(f"non-finite {name}")
    d = sim.statistics.data
    stats = dict(
        dofs=sim.mesh.n_dofs, newton_its=log.newton_steps,
        linear_its=log.linear_iterations,
        bulk_energy=float(d["Bulk Energy"][-1]),
        crack_energy=float(d["Crack Energy"][-1]),
        tcv=qoi.compute_tcv(sim.mesh, u.reshape(-1, sim.mesh.dim), phi))
    for k, v in stats.items():
        if not np.isfinite(v):
            raise AssertionError(f"non-finite {k}")
    return sim, stats, wall


def _stats_line(stats):
    return " ".join(f"{k}={v!r}" for k, v in stats.items())


# the split solve's device programs whose memory the main phase reports
SPLIT_SOLVE_EXES = ("_prepare64", "_prepare32_from64", "_prepare_levels",
                    "_cg_pass32")


@contextlib.contextmanager
def _recording_calls(module, names):
    """Wrap module.<name> for each name so that the last call of each
    (per `which` block) is recorded as (function, argument shapes,
    keyword arguments); yields the record.  Shapes keep their weak
    types and multi-device shardings, so lowering them reproduces the
    executables the solver ran (and hits the compile cache) without
    holding its arrays."""
    import jax

    def spec(x):
        if not isinstance(x, jax.Array):
            return x
        sharding = (x.sharding if len(x.sharding.device_set) > 1
                    else None)
        return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=sharding,
                                    weak_type=x.weak_type)

    calls = {}
    orig = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def recorded(*a, **kw):
            label = f"{name}[{kw['which']}]" if "which" in kw else name
            calls[label] = (fn, jax.tree.map(spec, a), kw)
            return fn(*a, **kw)
        return recorded

    for n, fn in orig.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in orig.items():
            setattr(module, n, fn)


def _memory_report(calls):
    """memory_analysis() of each recorded executable (the compiles hit
    the in-memory or persistent cache) and the device's peak use."""
    import jax
    if not calls:
        raise AssertionError("the step ran none of " +
                             ", ".join(SPLIT_SOLVE_EXES))
    best = None
    for name, (fn, a, kw) in sorted(calls.items()):
        m = fn.lower(*a, **kw).compile().memory_analysis()
        total = (m.argument_size_in_bytes + m.output_size_in_bytes
                 + m.temp_size_in_bytes)
        _print(f"# memory {name}: args {m.argument_size_in_bytes} "
               f"out {m.output_size_in_bytes} temp "
               f"{m.temp_size_in_bytes} total {total} bytes")
        if best is None or total > best[1]:
            best = (name, total)
    stats = jax.devices()[0].memory_stats() or {}
    _print(f"# memory largest executable: {best[0]} ({best[1]} bytes); "
           f"device peak_bytes_in_use "
           f"{stats.get('peak_bytes_in_use', 'not reported')}")


def phase_main(clock):
    from cracks_tpu.solvers import lattice
    c0 = clock.snapshot()
    p = _sneddon(6)
    _sim, st1, warm = _run_step(p)
    c1 = clock.snapshot()
    if st1["dofs"] != SNEDDON_2D_DOFS_REFINE6:
        raise AssertionError(f"refine 6 gave {st1['dofs']} DoFs")
    _print(f"# main warmup run: {_stats_line(st1)} wall {warm:.3f}s "
           f"(compile {c1[0] - c0[0]:.3f}s in {c1[1] - c0[1]} compiles, "
           f"{c1[2] - c0[2]} persistent-cache hits)")
    del _sim
    with _recording_calls(lattice, SPLIT_SOLVE_EXES) as calls:
        sim, st2, wall = _run_step(p)
    c2 = clock.snapshot()
    _print(f"# main timed run: {_stats_line(st2)} run wall {wall:.3f}s "
           f"step {sim.step_times[-1][2]:.3f}s "
           f"({c2[1] - c1[1]} compiles in the run)")
    _assert_close("main warmup vs timed run", st1, st2)
    _memory_report(calls)


def _assert_close(name, a, b, keys=("bulk_energy", "crack_energy",
                                    "tcv")):
    """Raise unless every key agrees within abs PARITY_ATOL or rel
    PARITY_RTOL; returns the largest relative difference."""
    worst = 0.0
    for k in keys:
        diff = abs(a[k] - b[k])
        if not (diff <= PARITY_ATOL or diff <= PARITY_RTOL * abs(a[k])):
            raise AssertionError(f"{name}: {k} {a[k]!r} vs {b[k]!r}")
        worst = max(worst, diff / abs(a[k]) if a[k] else diff)
    return worst


def _assert_split(arr, axis, n):
    """arr is split n ways along `axis`, one slab per device."""
    shard = {s.data.shape[axis] for s in arr.addressable_shards}
    if len(arr.sharding.device_set) != n or \
            max(shard) != -(-arr.shape[axis] // n):
        raise AssertionError(f"{arr.shape} not split {n} ways along "
                             f"axis {axis}: {arr.sharding}")


def phase_four(clock, n=4):
    """The multi-device paths, each against its one-device (or
    replicated) twin; the lattice-sharded step first, since its fine
    matvec is the one GSPMD partitions."""
    def run(p):
        c0 = clock.snapshot()
        sim, st, wall = _run_step(p)
        return sim, st, wall, clock.snapshot()[0] - c0[0]

    p1 = _sneddon(6)
    _s, st1, w1, c1 = run(p1)
    del _s
    _print(f"# four: 1 device: {_stats_line(st1)} wall {w1:.3f}s "
           f"(compile {c1:.1f}s)")

    siml, stl, wl, cl = run(p1.replace(n_devices=n,
                                       dof_sharding="lattice"))
    if not siml.sys.use_lattice_state:
        raise AssertionError("lattice DoF sharding did not engage")
    (U, _P, _Po, _Poo, _), _f, jacs, jacL64 = siml.sys._split_jac_cache_lat
    _assert_split(jacL64, 2, n)
    _assert_split(jacs[-1], 2, n)
    _assert_split(U, 1, n)
    rel = _assert_close("lattice-sharded x4", st1, stl)
    _print(f"# four: {n} devices lattice-sharded: {_stats_line(stl)} "
           f"wall {wl:.3f}s (compile {cl:.1f}s); state and operators "
           f"split {n} ways; parity ok (max rel diff {rel:.3e})")
    del siml, U, jacs, jacL64

    simr, str_, wr, cr = run(p1.replace(n_devices=n))
    _assert_split(simr.sys.ca.JxW, -1, n)
    _assert_split(simr.sys.lattice_ca32.JxW, -1, n)
    rel = _assert_close("replicated x4", st1, str_)
    _print(f"# four: {n} devices replicated: {_stats_line(str_)} "
           f"wall {wr:.3f}s (compile {cr:.1f}s); cell arrays split {n} "
           f"ways; parity ok (max rel diff {rel:.3e})")
    del simr

    # halo pool: a hanging-node mesh (local pre-refinement around the
    # slit), sharded-DoF mode against its replicated twin
    ph = _sneddon(HALO_REFINE, n_local_pre_refine=1,
                  value_phase_field_for_refinement=0.5, n_devices=n)
    simh_r, sthr, whr, chr_ = run(ph)
    if len(simh_r.mesh.hang_child) == 0:
        raise AssertionError("halo phase mesh has no hanging nodes")
    simh, sth, wh, ch = run(ph.replace(dof_sharding="lattice"))
    if not simh.sys.use_halo_state or simh.sys.use_lattice_state:
        raise AssertionError("halo-pool mode did not engage")
    part = simh.sys.halo_partition
    own = part.arrays.own_mask_p
    if own.shape[0] != n or \
            {s.data.shape[0] for s in own.addressable_shards} != {1}:
        raise AssertionError(f"halo pool not split {n} ways: "
                             f"{own.sharding}")
    if not part.n_loc < part.n_vertices:
        raise AssertionError("halo pool slots cover the whole mesh")
    rel = _assert_close("halo-pool x4", sthr, sth)
    _print(f"# four: halo pool on a hanging-node mesh: {_stats_line(sth)} "
           f"wall {wh:.3f}s (compile {ch:.1f}s; replicated twin "
           f"{whr:.3f}s, compile {chr_:.1f}s); pool "
           f"{part.n_loc}/{part.n_vertices} slots per device; parity ok "
           f"(max rel diff {rel:.3e})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device phases")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import cracks_tpu  # noqa: F401  (x64 and the compile cache first)

    n = 4 if args.four else 1
    devs = phase_device(n)
    clock = _CompileClock()
    phases = ([("four", lambda: phase_four(clock, n))] if args.four else
              [("golden", phase_golden), ("matvec", phase_matvec),
               ("oracle", phase_oracle),
               ("main", lambda: phase_main(clock))])
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        _print(f"# phase {name}: ok in {time.perf_counter() - t0:.1f}s")
    secs, count, hits = clock.snapshot()
    _print(f"# total {time.perf_counter() - t_all:.1f}s; backend compile "
           f"{secs:.1f}s in {count} compiles; {hits} persistent-cache "
           f"hits")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
