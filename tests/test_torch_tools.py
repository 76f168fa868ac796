"""The port's quality, fidelity and provenance tools
(``video_annotator_tpu_torch/tools/``) against the JAX package's
``benchmarks/quality.py`` and ``benchmarks/fidelity.py``, loaded by path,
on the CPU."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from video_annotator_tpu.camera import CameraPreset as JCameraPreset
from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions
from video_annotator_tpu.pipeline.render import render as jrender
from video_annotator_tpu_torch.tools import fidelity, provenance, quality

ROOT = Path(__file__).resolve().parent.parent
SHAKE_ATOL = 1e-3  # px


def load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  ROOT / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jfidelity():
    return load("fidelity")


@pytest.fixture(scope="module")
def jquality():
    return load("quality")


@pytest.mark.parametrize("h,w,seed", [(48, 64, 0), (241, 333, 7), (1440, 1920, 5)])
def test_textured_planes_match_jax(jfidelity, h, w, seed):
    np.testing.assert_array_equal(fidelity._textured(h, w, seed),
                                  jfidelity._textured(h, w, seed))


def test_textured_many_is_textured_of_each_seed():
    got = fidelity._textured_many(30, 40, [3, 4, 5])
    for g, s in zip(got, (3, 4, 5)):
        np.testing.assert_array_equal(g, fidelity._textured(30, 40, s))


@pytest.mark.parametrize("delta", [0, 1, 7])
def test_psnr_matches_jax(jfidelity, delta):
    a = fidelity._textured(40, 50, 1)
    b = a.copy()
    b[::3, ::2] = np.clip(b[::3, ::2].astype(int) + delta, 0, 255)
    assert fidelity.psnr(a, b) == jfidelity.psnr(a, b)


@pytest.fixture(scope="module")
def stabilised_clip(tmp_path_factory):
    """A small stabilised render by the JAX package, its trajectory file
    beside it."""
    d = tmp_path_factory.mktemp("quality")
    src = "synthetic://shaky?w=320&h=240&n=16&seed=11&shake=0.008&pan=0.002"
    dest = str(d / "out.y4m")
    jrender(src, dest, JRenderOptions(
        stabilise="smooth", preset=JCameraPreset.GOPRO_H4B_WIDE43_MEASURED,
        analysis_mode="tracked", stabilise_radius=10, output_dfov=70.0, stabilise_buffer=0.0))
    return src, dest


def test_measure_shake_matches_jax(jquality, stabilised_clip):
    src, dest = stabilised_clip
    for path in (dest, src):
        want = jquality.measure_shake(path, 10)
        got = quality.measure_shake(path, 10, "cpu")
        assert abs(got - want) <= SHAKE_ATOL, (path, got, want)
    assert quality.measure_shake(src, 10, "cpu") > 1.0  # the source does shake


def test_traj_rms_deg_matches_jax(jquality, stabilised_clip):
    src, dest = stabilised_clip
    got, want = quality.traj_rms_deg(dest, src), jquality.traj_rms_deg(dest, src)
    assert abs(got - want) <= 1e-3 and 0.0 < got < 0.1, (got, want)


def test_quality_rows_are_the_jax_tools(tmp_path):
    """The 18 configs, in the JAX tool's order (its committed
    ``benchmarks/quality.json``), each row with the JAX row's keys, at a
    small size on the CPU."""
    out = tmp_path / "quality.json"
    assert quality.main(["--w", "256", "--h", "192", "--n", "12", "--radius", "10",
                         "--device", "cpu", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    want = json.loads((ROOT / "benchmarks" / "quality.json").read_text())
    assert [r["config"] for r in rows] == [r["config"] for r in want]
    for r, w in zip(rows, want):
        assert set(r) - {"torch", "cuda"} == set(w), r["config"]
        assert r["backend"] == "cpu"
        assert all(np.isfinite(v) for k, v in r.items() if isinstance(v, float))
    names = [c[0] for c in quality.configs(70.0)]
    assert names == [r["config"] for r in want]


def test_fidelity_run_on_the_cpu(tmp_path):
    """``--device cpu`` at a small geometry: the plain warps against cv2,
    every plane and family over the 45 dB gate, the JSON saying which
    route was timed."""
    out = tmp_path / "fidelity.json"
    assert fidelity.main(["--size", "640x480", "--batch", "4", "--dispatches", "3",
                          "--device", "cpu", "--out", str(out)]) == 0
    r = json.loads(out.read_text())
    assert r["geometry"] == "640x480" and r["backend"] == "cpu"
    assert r["route"] == "the plain PyTorch versions on the CPU"
    assert min(r["psnr_luma_db"], r["psnr_chroma_u_db"], r["psnr_chroma_v_db"]) >= 45.0
    assert r["psnr_ok"] and r["families_psnr_ok"]
    assert set(r["families"]) == {"rotation_bicubic", "rotation_lanczos", "similarity",
                                  "deshake"}
    assert [f["oracle_independent"] for f in r["families"].values()] == [True, False, True,
                                                                          True]
    assert r["dispatches_timed"] == 3 and r["p50_warp_ms_per_frame"] > 0


@pytest.mark.parametrize("tool", [quality, fidelity])
def test_tools_ask_for_the_card_unless_told_cpu(monkeypatch, capsys, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_stamp_keys():
    """The JAX stamp's keys, the jax backend replaced by what ran the
    port: the card's name and power limit, or ``cpu``."""
    r = provenance.stamp({"x": 1}, "cpu")
    assert set(r) == {"x", "git_sha", "captured_at_utc", "torch", "cuda", "backend"}
    assert r["backend"] == "cpu" and r["torch"] == torch.__version__
    assert r["git_sha"] != "" and r["captured_at_utc"].endswith("Z")
    assert "git_sha" in load("provenance").stamp({}, "cpu")


def test_card_label_asks_nvidia_smi(monkeypatch):
    import subprocess

    calls = []

    def fake_run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "NVIDIA H100 80GB HBM3, 700.00 W\n", "")

    monkeypatch.setattr(subprocess, "run", fake_run)
    r = provenance.stamp({}, "cuda")
    assert r["backend"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"] in calls
