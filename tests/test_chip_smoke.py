"""chip_smoke.py: no result without a GPU or without the repository, and
its phases rehearsed end to end on the CPU at a small size (the full run
needs a card: `python chip_smoke.py` on the GPU machine)."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _json_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("{")]


def test_main_exits_nonzero_on_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert not _json_lines(out.out)
    assert "no GPU" in out.err


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not _json_lines(p.stdout)


def test_phases_rehearsal_small_cpu(tmp_path, capsys):
    """Phases 2-6 at 512^2 on the CPU: native build, cli process/batch
    equality, golden parity (default and CLAHE + linear), bf16 contract,
    histogram == np.bincount, campaign CSVs."""
    chip_smoke.run_phases(size=512, clahe_size=512, work=tmp_path / "w")
    out = capsys.readouterr().out
    for phase in range(2, 7):
        assert f"phase {phase}:" in out
    assert "equal to np.bincount" in out
    assert "batch outputs equal the 4 single-image outputs" in out
