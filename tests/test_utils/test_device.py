"""The pure helpers behind ``chip_smoke.py`` and ``bench.py``: refusal
without a GPU, the compile-cache rule, the ``nvidia-smi`` line, and the
scripts' own refusal to run (and print a result) on the CPU."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

from sopht_mpi_tpu.utils.compile_cache import (
    REPO_ROOT,
    compile_cache_dir,
    configure_compile_cache,
)
from sopht_mpi_tpu.utils.device import parse_nvidia_smi_line, require_gpu

sys.path.insert(0, str(REPO_ROOT))
import chip_smoke  # noqa: E402


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(SystemExit, match="found cpu"):
        require_gpu(jax.devices("cpu"))


def test_require_gpu_refuses_no_devices():
    with pytest.raises(SystemExit, match="no device"):
        require_gpu([])


def test_require_gpu_accepts_a_gpu_first():
    devs = [SimpleNamespace(platform="gpu"), SimpleNamespace(platform="gpu")]
    assert require_gpu(devs) is devs


@pytest.mark.parametrize("line,name,watts", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
    ("NVIDIA H100 80GB HBM3, 500.00 W", "NVIDIA H100 80GB HBM3", 500.0),
    ("NVIDIA H100 PCIe, [N/A]", "NVIDIA H100 PCIe", None),
    ("Card, with comma, 350 W", "Card, with comma", 350.0),
])
def test_parse_nvidia_smi_line(line, name, watts):
    assert parse_nvidia_smi_line(line) == {"name": name,
                                           "power_limit_w": watts}


def test_parse_nvidia_smi_line_rejects_other_text():
    with pytest.raises(ValueError):
        parse_nvidia_smi_line("No devices were found")


def test_compile_cache_uses_the_environment_when_set():
    env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/cache"}
    assert compile_cache_dir(env) == "/somewhere/cache"


def test_compile_cache_defaults_to_the_repo():
    path = compile_cache_dir({})
    assert path == str(REPO_ROOT / ".jax_cache")
    assert compile_cache_dir({}) == path  # fixed, never per-process


def test_configure_compile_cache_sets_nothing_when_env_names_one(
        monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/cache")
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert configure_compile_cache() == "/somewhere/cache"
    assert calls == []


@pytest.mark.parametrize("value,expected", [
    ("cpu", "cpu"), ("cuda", "cuda,cpu"), ("cuda,cpu", "cuda,cpu"),
    ("", ""), (None, None),
])
def test_jax_platforms_keep_the_cpu_backend(value, expected):
    assert chip_smoke.jax_platforms_with_cpu(value) == expected


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            pass
    return False


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_refuses_the_cpu(script):
    proc = _run([script], REPO_ROOT)
    assert proc.returncode != 0
    assert "needs an NVIDIA GPU" in proc.stderr
    assert not _has_result(proc.stdout)


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(REPO_ROOT / "chip_smoke.py", tmp_path)
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)
