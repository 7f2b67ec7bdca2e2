"""Test configuration: an 8-device virtual CPU mesh, set before jax import.

Multi-device sharding tests run against xla_force_host_platform_device_count=8.
JAX_PLATFORMS defaults to cpu; tests marked ``gpu`` need a card and skip
without one (run them on a GPU host with ``JAX_PLATFORMS=cuda,cpu python
-m pytest tests -m gpu`` — the CPU backend is the tie-order reference;
chip_smoke.py runs the same checks)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from hisat2_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on a CPU-only host)")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX sees none."""
    import jax
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: JAX sees only "
                    f"{jax.devices()[0].platform} devices")
    return devs[0]


@pytest.fixture
def cpu_backend():
    """The first CPU device, for checks that compare a GPU with the CPU;
    skips the test when JAX_PLATFORMS leaves the CPU backend out."""
    import jax
    try:
        return jax.devices("cpu")[0]
    except RuntimeError as e:
        pytest.skip(f"needs the CPU backend beside the GPU "
                    f"(JAX_PLATFORMS=cuda,cpu): {e}")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def small_index():
    """A ~20 kb random single-sequence index shared across tests."""
    from hisat2_tpu.index.builder import build_fm_index
    r = np.random.default_rng(1234)
    seq = r.integers(0, 4, 20000).astype(np.uint8)
    return build_fm_index([("chr_t", seq)]), seq


@pytest.fixture(scope="session")
def multi_index():
    """Two sequences with embedded N runs (fragment handling)."""
    from hisat2_tpu.index.builder import build_fm_index
    r = np.random.default_rng(99)
    s1 = r.integers(0, 4, 5000).astype(np.uint8)
    s1[1000:1100] = 4  # N run
    s2 = r.integers(0, 4, 3000).astype(np.uint8)
    s2[0:7] = 4        # leading Ns
    return build_fm_index([("c1", s1), ("c2", s2)]), [s1, s2]
