"""The platform decisions: the one per-platform choice of scan mode and
selection, the compile-cache location, the peaks table, and the two
measurement scripts refusing to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from fastpyvectordb_jax import compile_cache
from fastpyvectordb_jax.kernels import select

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform,codec,want", [
    ("cpu", "int8", "chunked"), ("cpu", "int4", "chunked"),
    ("gpu", "int8", "int8mm"), ("gpu", "int4", "int4mm")])
def test_auto_scan_mode_per_platform(platform, codec, want):
    assert select.scan_mode(codec, "auto", on=platform) == want


@pytest.mark.parametrize("codec,mode", [
    ("int8", "int8mm"), ("int8", "chunked"), ("int4", "int4mm"),
    ("int4", "chunked")])
def test_explicit_scan_mode_passes_through(codec, mode):
    assert select.scan_mode(codec, mode) == mode


@pytest.mark.parametrize("codec,mode", [
    ("int8", "pallas"), ("int4", "pallas"), ("int8", "int4mm"),
    ("binary", "auto")])
def test_unknown_scan_mode_raises(codec, mode):
    with pytest.raises(ValueError):
        select.scan_mode(codec, mode)


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_other_platforms_raise(monkeypatch, platform):
    monkeypatch.setattr(select.jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        select.platform()
    with pytest.raises(RuntimeError):
        select.scan_mode("int8")


def test_this_run_is_a_supported_platform():
    assert select.platform() in ("cpu", "gpu")


@pytest.mark.parametrize("quantizer", ["int8", "int4"])
def test_quantizer_rejects_pallas_mode(quantizer):
    import numpy as np
    from fastpyvectordb_jax.quant.int4 import Int4Quantizer
    from fastpyvectordb_jax.quant.scalar import ScalarQuantizer
    v = np.random.default_rng(0).standard_normal((32, 8)).astype(np.float32)
    qz = (ScalarQuantizer if quantizer == "int8" else Int4Quantizer)()
    qz.train(v)
    with pytest.raises(ValueError, match="scan mode"):
        qz.distances(v[:2], qz.encode(v), "l2", mode="pallas")


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.cache_dir() == str(tmp_path / "c")


def test_compile_cache_default_is_fixed_checkout_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == str(REPO / ".jax_cache")
    # fixed: no process id, time or temporary name in the path
    assert compile_cache.cache_dir() == compile_cache.cache_dir()
    assert str(os.getpid()) not in compile_cache.cache_dir()


def test_compile_cache_dir_is_gitignored():
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_peaks_table_has_h100_with_source():
    sys.path.insert(0, str(REPO))
    from benchmarks.peaks import PEAKS, peaks
    h100 = peaks("NVIDIA H100 80GB HBM3")
    assert "data sheet" in h100["source"]
    assert h100["flops"]["bfloat16"] == 989e12
    assert h100["hbm_bytes_per_s"] == 3.35e12
    assert all("source" in p for p in PEAKS.values())


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 PCIe"])
def test_peaks_unknown_device_kind_raises(kind):
    sys.path.insert(0, str(REPO))
    from benchmarks.peaks import peaks, roofline
    with pytest.raises(KeyError):
        peaks(kind)
    with pytest.raises(KeyError):
        roofline(kind, 1.0, flops=1.0)


def test_roofline_picks_the_binding_bound():
    sys.path.insert(0, str(REPO))
    from benchmarks.peaks import roofline
    kind = "NVIDIA H100 80GB HBM3"
    mem = roofline(kind, 1e-3, flops=1e9, flops_dtype="bfloat16",
                   bytes_moved=3.35e9)
    assert mem["bound"] == "memory"
    assert mem["roofline_share"] == pytest.approx(1.0)
    comp = roofline(kind, 2e-3, flops=989e9, flops_dtype="bfloat16",
                    bytes_moved=1.0)
    assert comp["bound"] == "compute"
    assert comp["roofline_share"] == pytest.approx(0.5)


def _run_cpu(script, cwd, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_measurement_scripts_fail_without_a_gpu(script, tmp_path):
    """On a CPU-only host both scripts exit non-zero and print no
    result."""
    r = _run_cpu(str(REPO / script), REPO, tmp_path)
    assert r.returncode != 0, r.stdout
    assert '"ok": true' not in r.stdout
    for line in r.stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            assert row.get("ok") is not True and "value" not in row


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    cannot find the program and fails without a result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_cpu("chip_smoke.py", tmp_path, tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_alias_resolves_to_the_same_modules():
    """An aliased name gives the package's own module objects, submodules
    included, so classes compare identical under both names."""
    import importlib
    import sys

    import fastpyvectordb_jax
    from fastpyvectordb_jax import _alias
    from fastpyvectordb_jax.core.collection import Collection
    alias = "fvdb_alias_probe"
    try:
        assert _alias.install(alias) is fastpyvectordb_jax
        assert importlib.import_module(alias) is fastpyvectordb_jax
        sub = importlib.import_module(alias + ".core.collection")
        assert sub.Collection is Collection
        assert sub.__spec__.name == "fastpyvectordb_jax.core.collection"
        assert importlib.import_module(alias).Collection is Collection
    finally:
        sys.meta_path[:] = [f for f in sys.meta_path
                            if getattr(f, "alias", None) != alias]
        for name in [m for m in sys.modules if m.split(".")[0] == alias]:
            del sys.modules[name]


def _alias_packages():
    return sorted(p.parent.name for p in REPO.glob("*/__init__.py")
                  if "_alias import install" in p.read_text())


@pytest.mark.parametrize("pkg", _alias_packages())
def test_former_package_name_still_imports(pkg):
    """The package's former import name still works, with a deprecation
    warning, and is the same package."""
    code = (f"import warnings; warnings.simplefilter('error', "
            f"DeprecationWarning)\ntry:\n    import {pkg}\n"
            f"except DeprecationWarning:\n    pass\nelse:\n"
            f"    raise SystemExit('no warning')\n"
            f"warnings.simplefilter('ignore')\n"
            f"import {pkg}, fastpyvectordb_jax\n"
            f"from {pkg}.core.collection import Collection\n"
            f"from fastpyvectordb_jax.core import collection\n"
            f"assert {pkg} is fastpyvectordb_jax\n"
            f"assert Collection is collection.Collection\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
