"""Entry-point plumbing that runs on any platform: the compile-cache
placement helper and the GPU guards of chip_smoke.py and bench.py."""

import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    import jax

    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env(monkeypatch, tmp_path, restore_cache_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache directory."""
    import jax

    from openmm_agbnp_jax.utils import compile_cache as cc

    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_in_checkout(monkeypatch, restore_cache_dir):
    """Without the variable the cache sits at one fixed path inside the
    checkout, which .gitignore lists."""
    import jax

    from openmm_agbnp_jax.utils import compile_cache as cc

    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    path = cc.enable_compile_cache()
    assert path == cc.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("script", ["chip_smoke", "bench"])
def test_gpu_guard_refuses_cpu(script, capsys):
    """Both measurement entry points refuse a non-GPU default device: they
    exit non-zero before running anything and print no result line."""
    import importlib
    import sys

    import jax

    if jax.devices()[0].platform == "gpu":
        pytest.skip("the default device is a GPU")
    sys.path.insert(0, REPO)
    try:
        mod = importlib.import_module(script)
        with pytest.raises(SystemExit) as exc:
            mod.main([]) if script == "chip_smoke" else mod.main()
    finally:
        sys.path.remove(REPO)
    assert exc.value.code not in (0, None)
    assert "not a GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out
