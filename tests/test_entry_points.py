"""Entry points that must refuse to run without a GPU, and the choice
of the persistent compilation-cache directory."""

import os
import shutil
import subprocess
import sys

import pytest

from .regression import REPO_ROOT


def _run(args, cwd=REPO_ROOT, **env):
    e = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


def test_cache_dir_honours_environment():
    from cracks_tpu import compilation_cache_dir
    assert compilation_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/c"}) \
        is None


def test_cache_dir_is_fixed_in_checkout():
    from cracks_tpu import compilation_cache_dir
    d = compilation_cache_dir({})
    assert d == os.path.join(REPO_ROOT, ".jax_cache")
    assert d == compilation_cache_dir({})
    assert str(os.getpid()) not in os.path.basename(d)


@pytest.mark.parametrize("env_dir", [False, True])
def test_package_import_sets_cache_dir(tmp_path, env_dir):
    """Importing the package leaves JAX_COMPILATION_CACHE_DIR in force
    when it is set, and otherwise points JAX at <checkout>/.jax_cache."""
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_dir else {}
    if not env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = ""
    r = _run(["-c", "import cracks_tpu, jax; "
              "print(jax.config.jax_compilation_cache_dir)"], **env)
    assert r.returncode == 0, r.stderr
    want = (str(tmp_path) if env_dir
            else os.path.join(REPO_ROOT, ".jax_cache"))
    assert r.stdout.strip().splitlines()[-1] == want


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_cpu(tmp_path, alone):
    """No GPU (or no repository beside it): non-zero exit, no result."""
    cwd = REPO_ROOT
    script = os.path.join(REPO_ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path)
        cwd, script = str(tmp_path), str(tmp_path / "chip_smoke.py")
    r = _run([script], cwd=cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu():
    r = _run([os.path.join(REPO_ROOT, "bench.py")])
    assert r.returncode != 0
    assert "{" not in r.stdout
