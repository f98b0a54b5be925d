"""Process-level setup: compile-cache placement, matmul precision, the
native library build, and chip_smoke.py's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_env(**overrides):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(overrides)
    return env


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX (the package
    sets no directory); otherwise the cache is <checkout>/.jax_cache."""
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")} \
        if env_set else {}
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, ninpol_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=_child_env(**extra), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = (str(tmp_path / "cc") if env_set
            else os.path.join(REPO, ".jax_cache"))
    assert out.stdout.strip().splitlines()[-1] == want


def test_highest_precision_gram_matches_float64():
    """import ninpol_tpu forces "highest" matmul precision (TF32 or
    bfloat16 passes would miss by ~1e-4..1e-3), and the Gram helper at
    the dominant GLS width (m=132 rows, n=73 columns) matches float64."""
    import jax
    import ninpol_tpu  # noqa: F401
    from ninpol_tpu.ops.solve import gram_f32

    assert jax.config.jax_default_matmul_precision == "highest"
    A = np.random.default_rng(5).standard_normal(
        (32, 132, 73)).astype(np.float32)
    G = np.asarray(jax.jit(gram_f32)(A))
    A64 = A.astype(np.float64)
    ref = np.einsum("bmn,bmk->bnk", A64, A64)
    assert np.abs(G - ref).max() / np.abs(ref).max() <= 1e-5


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_native_library_builds_from_source(tmp_path, monkeypatch):
    """With no library next to the source, available() compiles
    topology.cpp and loads the result (the .so is not version-
    controlled)."""
    from ninpol_tpu import native

    src = tmp_path / "topology.cpp"
    shutil.copy(native._SRC, src)
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.delenv("NINPOL_TPU_NATIVE", raising=False)
    so = tmp_path / "_ninpol_topology.so"
    assert not so.exists()
    assert native.available()
    assert so.exists() and not (tmp_path / "_ninpol_topology.so.tmp").exists()
    assert native.lib().build_esup is not None


def test_chip_smoke_refuses_cpu():
    """On the CPU chip_smoke.py exits non-zero and never claims success."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=_child_env(JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=600)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.fixture
def gpu_card():
    """The card's nvidia-smi name and power limit, or skip: decided here,
    at run time, never while the module is imported."""
    sys.path.insert(0, REPO)
    from bench import card_info
    card = card_info()
    if card is None:
        pytest.skip("no NVIDIA GPU on this host")
    return card


@pytest.mark.gpu
def test_chip_smoke_passes_on_gpu(gpu_card):
    """The full-size start-up proof, on the card (python -m pytest -m gpu).
    The child owns the card; this process stays on the CPU."""
    env = _child_env()
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    assert '"ok": true' in out.stdout.strip().splitlines()[-1], gpu_card
