"""Start-up behaviour of the entry points: compile-cache placement, the
CLI's jax backend (no silent oracle fallback), and chip_smoke.py
refusing any device but a GPU."""

import json
import os
import subprocess
import sys

import jax
import pytest

from alacjax import cli
from alacjax.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def cache_config(monkeypatch):
    """Cache switched on (the test tier keeps it off) and its directory
    restored afterwards."""
    before = (jax.config.jax_enable_compilation_cache,
              jax.config.jax_compilation_cache_dir)
    jax.config.update("jax_enable_compilation_cache", True)
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_enable_compilation_cache", before[0])
    jax.config.update("jax_compilation_cache_dir", before[1])


def test_cache_env_set_is_honoured(cache_config, monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.place_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None  # set by no code


def test_cache_env_unset_uses_checkout(cache_config, monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    want = os.path.join(ROOT, ".jax_cache")
    assert compile_cache.checkout_root() == ROOT
    assert compile_cache.place_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_cache_off_places_nothing(monkeypatch):
    assert not jax.config.jax_enable_compilation_cache  # the test tier
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.place_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("backend", [None, "jax"])
def test_cli_jax_backend_fails_instead_of_oracle(monkeypatch, tmp_path,
                                                 capsys, backend):
    """A jax backend that cannot start exits nonzero; nothing converts on
    the host oracle behind the user's back."""
    def broken():
        raise RuntimeError("no device")

    def must_not_convert(*a, **k):
        raise AssertionError("converted without a working jax backend")
    monkeypatch.setattr(cli, "_start_jax", broken)
    import alacjax.convert as convert
    monkeypatch.setattr(convert, "convert_file", must_not_convert)
    argv = [str(tmp_path / "a.wav"), str(tmp_path / "a.caf")]
    if backend:
        argv += ["--backend", backend]
    assert cli.main(argv) == 1
    assert "jax backend unavailable: no device" in capsys.readouterr().err


def test_cli_oracle_backend_skips_jax_start(monkeypatch, tmp_path):
    monkeypatch.setattr(cli, "_start_jax", lambda: (_ for _ in ()).throw(
        AssertionError("oracle backend must not start jax")))
    assert cli.main([str(tmp_path / "missing.wav"),
                     str(tmp_path / "o.caf"), "--backend", "oracle"]) != 0


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def _has_result_line(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_chip_smoke_refuses_cpu():
    proc = _run_smoke(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stderr + proc.stdout
    assert not _has_result_line(proc.stdout)


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repo the script fails and prints no
    result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    proc = _run_smoke(str(tmp_path), str(script))
    assert proc.returncode != 0
    assert not _has_result_line(proc.stdout)
