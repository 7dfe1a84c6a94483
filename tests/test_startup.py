"""Start-up behaviour: the compile-cache location and chip_smoke.py's
refusal to run without a GPU.  Each case runs in a fresh CPU process, so
the package's import-time configuration is what is checked."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_extra, cwd=REPO, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO})
    env.update(env_extra)
    return subprocess.run(
        [sys.executable] + args, env=env, cwd=cwd, capture_output=True, text=True, timeout=timeout
    )


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache; otherwise the
    cache is <checkout>/.jax_cache."""
    extra = {} if env_dir is None else {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / env_dir)}
    out = _run(
        ["-c", "import dmsa_lidar_slam_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        extra,
    )
    assert out.returncode == 0, out.stderr
    want = str(tmp_path / env_dir) if env_dir else os.path.join(REPO, ".jax_cache")
    assert out.stdout.strip().splitlines()[-1] == want


def test_chip_smoke_refuses_without_gpu():
    out = _run([os.path.join(REPO, "chip_smoke.py")], {})
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Outside the repository the script has no program to run."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run([str(tmp_path / "chip_smoke.py")], {"PYTHONPATH": ""}, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
