"""The `musica_tpu` import alias must be a true alias: every dotted path
through it resolves to the SAME module object as the canonical package
import (a duplicate module would carry its own jit caches and break
`isinstance`/identity checks across the two spellings)."""

import os
import subprocess
import sys


def test_alias_exports_and_identity():
    import musica_tpu
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu import (
        config,
    )
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import (
        musica,
    )

    assert musica_tpu.MusicaConfig is config.MusicaConfig
    assert musica_tpu.__version__
    assert musica_tpu.models.musica is musica

    import musica_tpu.models.musica as alias_musica

    assert alias_musica is musica


def test_alias_covers_every_submodule():
    """The shim discovers submodules by walking the package (no hand list):
    EVERY canonical module must have its musica_tpu.* alias registered, so
    adding a new module can't silently reintroduce the duplicate-module bug."""
    import pkgutil

    import musica_tpu  # noqa: F401
    import metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu as pkg

    walked = list(pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))
    assert len(walked) > 20  # sanity: the walk actually found the tree
    for info in walked:
        alias = "musica_tpu." + info.name[len(pkg.__name__) + 1:]
        assert alias in sys.modules, f"missing alias {alias}"
        assert sys.modules[alias] is sys.modules[info.name], alias


def test_alias_submodule_import_fresh_process_no_duplicate():
    """In a process where NOTHING was pre-imported, a dotted import through
    the alias must still land on the canonical module object."""
    code = (
        "import musica_tpu.utils.viewer as v\n"
        "from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils"
        " import viewer\n"
        "assert v is viewer, 'alias created a duplicate module'\n"
        "import musica_tpu.ops.stats as st\n"
        "from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops"
        " import stats\n"
        "assert st is stats\n"
        "print('ALIAS-OK')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert p.returncode == 0, p.stderr[-800:]
    assert "ALIAS-OK" in p.stdout
