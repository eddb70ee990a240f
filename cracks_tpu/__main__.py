"""Command-line driver: ``python -m cracks_tpu <parameters.prm>``.

Mirrors the reference CLI (cracks.cc:4585-4686): with no arguments,
runs the unit-test suite (if pytest is available) and writes a
default.prm; with a parameter file, runs the simulation, echoing the
resolved parameters and the statistics table into the output directory.
"""

import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        # reference behavior (cracks.cc:4589-4594): no arguments runs
        # the embedded unit tests, then emits a default.prm.  The
        # reference's embedded suite is the 6 Catch eigensolver cases
        # (cracks.cc:1740-1919); the analogue here is the spectral-split
        # test module (the full regression suite lives under pytest).
        rc = 0
        import os
        tests_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests")
        spectral = os.path.join(tests_dir, "test_spectral.py")
        if os.path.exists(spectral):
            try:
                import pytest
                rc = pytest.main(["-q", spectral])
            except ImportError:  # pragma: no cover
                print("(pytest unavailable — skipping unit tests)")
        if rc != 0:
            # mirror the reference's early return on unit-test failure
            # (cracks.cc:4589-4594): no default.prm is emitted
            return int(rc)
        from .config import default_parameters, dump_parameters
        with open("default.prm", "w") as f:
            f.write(dump_parameters(default_parameters()))
        print("usage: python -m cracks_tpu <parameter_file>")
        print(" (created default.prm)")
        return int(rc)

    from .config import load_parameters
    from .driver import run_prm

    overrides = {}
    for extra in argv[1:]:
        # allow key=value overrides of Parameters fields
        key, _, value = extra.partition("=")
        overrides[key] = type(getattr(load_parameters(argv[0]), key))(value)

    p = load_parameters(argv[0], **overrides)
    import jax
    devs = jax.devices()
    print(f"# platform={devs[0].platform} "
          f"device_kind={devs[0].device_kind} count={len(devs)}")
    print(f"Problem dimension: {p.dimension}")
    # run_prm honors `Resume from` (checkpoint resume) — the CLI must
    # route through it, not construct a fresh Simulation
    run_prm(argv[0], **overrides)
    return 0


if __name__ == "__main__":
    sys.exit(main())
