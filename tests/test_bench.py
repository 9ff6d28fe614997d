"""bench.py and the device helpers it reports with: one process, timings
that wait for the device, and no result at all without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402


def test_bench_main_refuses_cpu(capsys):
    assert bench.main() != 0
    out = capsys.readouterr()
    assert "{" not in out.out
    assert "no GPU" in out.err


def test_bench_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


def test_time_call_waits_for_each_call():
    f = jax.jit(lambda a: (a * 2.0).sum())
    x = jax.numpy.ones((64, 64))
    ts = bench.time_call(f, (x,), 3)
    assert len(ts) == 3 and all(t > 0 for t in ts)


def test_measure_small_size_checks_batch_against_single():
    """The measurement path itself, at a toy size on the CPU: both
    programs run, the batch equals the single-image output, and the
    result carries set-up and timed numbers."""
    res = bench.measure(size=64, batch=2, iters=2)
    assert res["size"] == 64 and res["batch"] == 2
    for k in ("single_ms", "batch_ms_per_image"):
        assert 0 < res[k]["min"] <= res[k]["median"]
    assert res["setup_s"]["single"] > 0 and res["setup_s"]["batch"] > 0


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_device_record_keys():
    rec = device.device_record()
    assert set(rec) == {"platform", "kind", "count"}
    assert rec["platform"] == "cpu"
    assert rec["count"] == len(jax.devices())


def test_card_line_needs_nvidia_smi(monkeypatch, tmp_path):
    """The card is read with nvidia-smi or not at all: no made-up name."""
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises((FileNotFoundError, subprocess.CalledProcessError)):
        device.card_line()


def test_card_line_is_first_line_of_nvidia_smi(monkeypatch, tmp_path):
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n"
                    "echo 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert device.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
