"""One dispatch on every backend: the path a plan takes depends on its
filter lengths and dtype only; what the class API forces is forced
everywhere; the compile-cache rule; and ``chip_smoke.py`` refuses to run
without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import non_decimated_wavelets as nw
from non_decimated_wavelets import oracle
from non_decimated_wavelets.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "shape,wv,dtype,expected",
    [
        ((164, 64, 40), "db4", jnp.float32, "direct"),
        ((164, 64, 40), ("db1", "db3", "db9"), jnp.float32, "fft"),
        ((64, 64, 20, 10), "db2", jnp.float32, "direct"),
        ((32, 32, 32, 130), "db4", jnp.float32, "direct"),
        ((54321,), "db10", jnp.float32, "fft"),
        ((250, 250, 250), "db6", jnp.bfloat16, "direct"),
        ((164, 64, 40), "db10", jnp.float64, "direct"),
        ((128, 128, 128, 128), "db8", jnp.bfloat16, "fft"),
    ],
)
def test_resolve_path_same_on_gpu(shape, wv, dtype, expected, monkeypatch):
    """``'auto'``: direct for f64 and for filters of <= 12 taps, fft above;
    the answer does not change when the backend reports a GPU."""
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=dtype)
    on_cpu = plan._resolve_path()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert plan._resolve_path() == on_cpu == expected


@pytest.mark.parametrize("path", ["direct", "fft"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_explicit_path_and_complex_on_gpu(path, dtype, rng, monkeypatch):
    """An explicit path is honoured, and complex input and f64 ``'fft'``
    run, with the backend reporting a GPU: nothing is refused."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    shape, wv, level = (16, 12), ("db2", "db3"), 2
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=dtype, path=path)
    assert plan._resolve_path() == path
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    y = plan.dec(x, level)
    tol = 1e-12 if dtype == jnp.float64 else 1e-5
    np.testing.assert_allclose(np.asarray(y), oracle.dec(x, wv, level),
                               atol=tol)
    np.testing.assert_allclose(np.asarray(plan.rec(y)), x, atol=10 * tol)


@pytest.mark.parametrize("method,path", [("conv", "direct"), ("fft", "fft")])
def test_4d_method_forces_path_on_gpu(method, path, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    t = nw.nd_dwt_4D("db2", (8, 8, 6, 6), method=method)
    assert t.plan._resolve_path() == path


@pytest.mark.parametrize("cls,shape", [(nw.harr_nddwt_2D, (16, 18)),
                                       (nw.harr_nddwt_4D, (8, 6, 6, 4))])
def test_haar_classes_use_direct_on_gpu(cls, shape, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert cls(sizes=shape).plan._resolve_path() == "direct"


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_rule(env_set, tmp_path, monkeypatch):
    """``JAX_COMPILATION_CACHE_DIR`` wins when set (and nothing else is
    set in code); otherwise the cache is the fixed ``.jax_cache`` beside
    the package, whatever the working directory."""
    monkeypatch.chdir(tmp_path)
    set_dirs = []
    monkeypatch.setattr(
        jax.config, "update",
        lambda name, value: set_dirs.append((name, value)),
    )
    if env_set:
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cc"))
        assert compile_cache.enable_compile_cache() == str(tmp_path / "cc")
        assert set_dirs == []
    else:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        want = os.path.join(REPO, ".jax_cache")
        assert compile_cache.enable_compile_cache() == want
        assert set_dirs == [("jax_compilation_cache_dir", want)]
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(alone, tmp_path):
    """On the CPU, and in a directory holding only the script, it exits
    non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
