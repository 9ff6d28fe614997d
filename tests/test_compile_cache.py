"""Where the persistent compile cache goes (utils/compile_cache.py): the
environment's directory when JAX_COMPILATION_CACHE_DIR is set, else one
fixed directory inside the checkout."""

import os
from pathlib import Path

import jax

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu import cli
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def test_env_dir_wins_and_nothing_is_set(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == str(tmp_path / "env")
    assert calls == []


def test_default_is_fixed_dir_in_checkout(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.chdir(tmp_path)  # independent of the working directory
    try:
        got = compile_cache.enable_compile_cache()
        assert got == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_default_dir_is_ignored_by_git():
    lines = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines
    assert compile_cache.DEFAULT_DIR.parent == REPO


def test_cli_main_applies_the_rule(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda: calls.append(1) or "x")
    assert cli.main(["mean-cnr", str(tmp_path)]) == 0
    assert calls == [1]


def test_suite_uses_the_rule():
    """conftest.py applies the same rule to the test processes."""
    want = os.environ.get("JAX_COMPILATION_CACHE_DIR",
                          str(REPO / ".jax_cache"))
    assert jax.config.jax_compilation_cache_dir == want
