"""What the package decides about the device it runs on: the compile
cache's place, the dtype default, the device memory size, the peak-rate
table, and the benchmark's refusal to measure without a GPU."""

import os

import jax
import numpy as np
import pytest

from scs_tpu import Settings, settings as settings_mod
from scs_tpu.batch import batch_memory_bytes, device_hbm_bytes, recommend_chunks
from scs_tpu.bench_cli import (
    PEAK_HBM_GBPS,
    device_record,
    gen_batch,
    gen_batch_device,
    peak_hbm_gbps,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_dir_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert settings_mod.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_dir_defers_to_jax_variable(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert settings_mod.compile_cache_dir() is None


def test_ensure_compile_cache_sets_nothing_when_variable_set(
    monkeypatch, tmp_path
):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(settings_mod, "_CACHE_DONE", False)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    settings_mod.ensure_compile_cache()
    assert calls == []


@pytest.fixture
def no_cache_configured(monkeypatch):
    """The process as if nothing had configured a cache directory yet."""
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(settings_mod, "_CACHE_DONE", False)
    yield
    monkeypatch.undo()
    jax.config.update("jax_compilation_cache_dir", old)


def test_ensure_compile_cache_sets_fixed_dir(no_cache_configured,
                                             monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    settings_mod.ensure_compile_cache()
    settings_mod.ensure_compile_cache()  # once per process
    assert calls == [
        ("jax_compilation_cache_dir", os.path.join(REPO, ".jax_cache"))
    ]


def test_ensure_compile_cache_keeps_host_choice(no_cache_configured,
                                                monkeypatch, tmp_path):
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    settings_mod.ensure_compile_cache()
    assert calls == []


def test_session_cache_follows_policy():
    """conftest calls ensure_compile_cache: the session's cache is the
    JAX variable's directory, or else the fixed one in the checkout."""
    expected = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO, ".jax_cache"
    )
    assert jax.config.jax_compilation_cache_dir == expected


@pytest.mark.parametrize("backend", ["cpu", "gpu", "tpu"])
def test_auto_dtype_is_float64_on_every_backend(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert Settings(dtype="auto").dtype == "float64"
    assert Settings(dtype="float64").dtype == "float64"
    assert Settings(dtype="float32").dtype == "float32"


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_device_hbm_bytes_raises_without_stats(stats):
    with pytest.raises(RuntimeError, match="no memory limit"):
        device_hbm_bytes(_FakeDevice(stats))


def test_device_hbm_bytes_reads_limit():
    assert device_hbm_bytes(_FakeDevice({"bytes_limit": 60 * 2**30})) == (
        60 * 2**30
    )


def test_device_hbm_bytes_raises_on_cpu():
    with pytest.raises(RuntimeError):
        device_hbm_bytes(jax.devices("cpu")[0])


def test_recommend_chunks_with_budget():
    peak, _ = batch_memory_bytes(512, 1500, 1000, has_P=True, itemsize=4)
    assert recommend_chunks(512, 1500, 1000, True, budget=10 * peak) == 1
    assert recommend_chunks(512, 1500, 1000, True, budget=peak) == 1
    # just under the peak needs two sub-batches; chunk counts are powers
    # of two, capped at B
    assert recommend_chunks(512, 1500, 1000, True, budget=peak - 1) == 2
    assert recommend_chunks(512, 1500, 1000, True, budget=peak // 3) == 4
    assert recommend_chunks(4, 1500, 1000, True, budget=1) == 4


def test_peak_table_h100():
    assert peak_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert list(PEAK_HBM_GBPS) == ["NVIDIA H100 80GB HBM3"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200", "NVIDIA A100-SXM4-80GB"])
def test_peak_table_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no published peak"):
        peak_hbm_gbps(kind)


def test_device_record_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        device_record()


def test_gen_batch_device_planted_optimum():
    """p* returned with the device-generated batch is the optimum of the
    f32 problems it comes with: a tight f64 solve of each reaches it."""
    from scipy import sparse

    import scs_tpu

    A, P, b, c, p_star = gen_batch_device(3, 40, 24, seed=5)
    assert A.dtype == np.float32 and p_star.dtype == np.float64
    assert p_star.shape == (3,)
    for i in range(3):
        Pi = np.asarray(P[i], np.float64)
        sol = scs_tpu.solve(
            {"A": sparse.csc_matrix(np.asarray(A[i], np.float64)),
             "P": sparse.csc_matrix(np.triu(Pi)),
             "b": np.asarray(b[i], np.float64),
             "c": np.asarray(c[i], np.float64)},
            {"l": 40}, eps_abs=1e-8, eps_rel=1e-8, verbose=False,
            max_iters=20000,
        )
        assert sol["info"]["status"] == "solved"
        # info's pobj is reported in f32: 1e-5 relative is well above it
        assert abs(sol["info"]["pobj"] - p_star[i]) < 1e-5 * (
            1 + abs(p_star[i])
        )


def test_gen_batch_host_returns_planted_optimum():
    A, P, b, c, p_star = gen_batch(2, 30, 16, seed=3, return_opt=True)
    assert A.shape == (2, 30, 16) and p_star.shape == (2,)
