"""chip_smoke.py refuses to run without a GPU and outside a checkout,
and prints no result line then."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_device_check_refuses_the_cpu():
    with pytest.raises(SystemExit, match="not a GPU"):
        _load().check_device(jax)


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_a_gpu():
    proc = _run(REPO, SCRIPT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_exits_nonzero_outside_a_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    proc = _run(str(tmp_path), str(lone))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
