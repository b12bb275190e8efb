"""chip_smoke.py and the compile-cache helper, on the CPU.

The smoke test itself needs a GPU; what can be checked here is that it
refuses anything else, and the exact form of the line it ends with.
"""

import json

import jax
import pytest

import chip_smoke
from mf_data_locality.utils import compile_cache


def test_chip_smoke_refuses_cpu_device(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_last_line_format():
    line = chip_smoke.last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable()
        assert path == str(compile_cache.REPO_CACHE_DIR)
        assert compile_cache.REPO_CACHE_DIR.parent.joinpath(
            "chip_smoke.py").is_file()  # <repo>/.jax_cache
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
