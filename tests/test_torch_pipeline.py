"""The torch port's render path end to end on the CPU, held against the
JAX package: trajectory files, the encode half driven by a JAX-written
trajectory, the whole slice on a synthetic clip, the CLI surface, and
the port's import hygiene."""

import argparse
import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from video_annotator_tpu import cli as jcli
from video_annotator_tpu import so3 as jso3
from video_annotator_tpu.camera import CameraPreset as JCameraPreset
from video_annotator_tpu.io.synthetic import SyntheticSource as JSyntheticSource
from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions
from video_annotator_tpu.pipeline.render import analyse as janalyse
from video_annotator_tpu.pipeline.render import render as jrender
from video_annotator_tpu.pipeline.trajectory import Trajectory as JTrajectory
from video_annotator_tpu_torch import cli as tcli
from video_annotator_tpu_torch import so3 as tso3
from video_annotator_tpu_torch.camera import CameraPreset
from video_annotator_tpu_torch.io.synthetic import SyntheticSource
from video_annotator_tpu_torch.io.video import open_reader
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory

REPO = Path(__file__).resolve().parent.parent
PRESET = "gopro_h4b_wide43_measured"
MIN_EQUAL = 0.999
ANGLE_TOL_DEG = 0.05  # per frame, port vs JAX (the JAX CPU path tracks with XLA LK)


@pytest.fixture(autouse=True)
def few_threads():
    """Each render runs torch on three threads (decode, main, writer); at
    these sizes a full intra-op pool per thread only oversubscribes the
    cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def read_frames(path):
    r = open_reader(str(path))
    frames = [tuple(np.array(p) for p in f) for f in r]
    meta = r.meta
    r.close()
    return meta, frames


def assert_u8_close(got, want):
    got = np.asarray(got, np.int16)
    want = np.asarray(want, np.int16)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() >= MIN_EQUAL, (got == want).mean()


def angle_deg(Ra, Rb):
    rel = tso3.matmul(torch.tensor(Ra), tso3.transpose(torch.tensor(Rb)))
    return np.degrees(torch.linalg.vector_norm(tso3.log(rel), dim=-1).numpy())


def rms_vs_truth(traj_rotations, src):
    cfg = JSyntheticSource.from_uri(src).config
    r_true = np.asarray(jso3.exp(cfg.rotation_vectors()))
    r_expect = r_true.transpose(0, 2, 1) @ r_true[0]
    err = angle_deg(traj_rotations, r_expect[: len(traj_rotations)])
    return float(np.sqrt(np.mean(err ** 2)))


def test_trajectory_files_interchange(tmp_path):
    params = np.random.default_rng(0).normal(size=(7, 3)) * 0.1
    JTrajectory(params=params, width=64, height=48, source="x.y4m").save(
        str(tmp_path / "j.npz"))
    t = Trajectory.load(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(t.params, params)
    assert (t.width, t.height, t.source, t.kind) == (64, 48, "x.y4m", "so3")
    t.up0 = np.array([0.0, -1.0, 0.0])
    t.save(str(tmp_path / "t.npz"))
    j = JTrajectory.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(j.params, params)
    np.testing.assert_array_equal(j.up0, t.up0)
    np.testing.assert_allclose(t.rotations(), j.rotations(), atol=1e-6)
    with np.load(str(tmp_path / "j.npz")) as a, np.load(str(tmp_path / "t.npz")) as b:
        assert set(a.files) | {"up0"} == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k


def test_synthetic_frames_match_jax():
    src = "synthetic://shaky?w=160&h=120&n=3&seed=2"
    for got, want in zip(SyntheticSource.from_uri(src), JSyntheticSource.from_uri(src)):
        for g, w in zip(got, want):
            assert_u8_close(g, w)


def test_encode_only_from_jax_trajectory(tmp_path):
    src = "synthetic://shaky?w=640&h=480&n=12&seed=4"
    jdest, tdest = tmp_path / "jax.y4m", tmp_path / "torch.y4m"
    jrender(src, str(jdest), JRenderOptions(stabilise="smooth", analyse_only=True,
                                            analysis_mode="paired",
                                            preset=JCameraPreset(PRESET)))
    os.link(str(jdest) + ".traj.npz", str(tdest) + ".traj.npz")
    jrender(src, str(jdest), JRenderOptions(stabilise="smooth", encode_only=True,
                                            preset=JCameraPreset(PRESET),
                                            encoder="mp4v"))
    trender.render(src, str(tdest), trender.RenderOptions(
        stabilise="smooth", encode_only=True, preset=CameraPreset(PRESET)),
        device="cpu")
    jmeta, jframes = read_frames(jdest)
    tmeta, tframes = read_frames(tdest)
    assert (tmeta.width, tmeta.height, tmeta.num_frames) == \
        (jmeta.width, jmeta.height, jmeta.num_frames) == (jmeta.width, jmeta.height, 12)
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert_u8_close(tp, jp)


def test_render_slice_matches_jax(tmp_path):
    src = "synthetic://shaky?w=640&h=480&n=24&seed=1"
    jtraj = janalyse(src, JRenderOptions(stabilise="smooth", analysis_mode="paired",
                                         preset=JCameraPreset(PRESET)))
    dest = tmp_path / "out.y4m"
    prof = trender.StageProfiler()
    trender.render(src, str(dest), trender.RenderOptions(
        stabilise="smooth", analysis_mode="paired", preset=CameraPreset(PRESET)),
        profiler=prof, device="cpu")
    ttraj = Trajectory.load(str(dest) + ".traj.npz")
    assert ttraj.num_frames == jtraj.num_frames == 24
    assert angle_deg(ttraj.rotations(), jtraj.rotations()).max() <= ANGLE_TOL_DEG
    t_rms = rms_vs_truth(ttraj.rotations(), src)
    j_rms = rms_vs_truth(jtraj.rotations(), src)
    assert t_rms <= j_rms + max(0.2 * j_rms, 0.01), (t_rms, j_rms)
    meta, frames = read_frames(dest)
    assert meta.num_frames == 24 and len(frames) == 24
    assert {"decode", "track", "warp", "encode"} <= set(prof.totals()[0])


def test_encode_only_without_trajectory_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        trender.render("synthetic://shaky?w=64&h=48&n=2", str(tmp_path / "o.y4m"),
                       trender.RenderOptions(stabilise="smooth", encode_only=True),
                       device="cpu")


@pytest.mark.parametrize("field,value", [
    ("debug", True), ("crop_rect", "64:48"), ("device_sink", True),
    ("interp", "bicubic"), ("projection", "equirect"), ("interp", "lanczos"),
    ("preview", "p.png"), ("display", True), ("prefilter", "auto"),
])
def test_unported_options_raise(tmp_path, field, value, capsys):
    """Every render option once refused here now renders as the JAX
    package does (a rolled attitude instead of stabilisation, so no
    analyser runs): frames within one count, the same size. ``--crop
    W:H`` crops (here it clamps to the 62x46 frame),
    ``--debug`` draws the HUD, ``--preview DIR`` (a directory
    named ``p.png``) writes the same PNGs, ``--display`` on a host without
    a GUI warns and renders, and ``device_sink``, which only the
    streaming render reads, leaves the two-phase render as it is. At this
    size no tile of the prefilter's level map engages, as the JAX CPU
    fallback's global level does not."""
    import cv2

    src = "synthetic://shaky?w=64&h=48&n=2"
    kw = {"roll": 3.0, "pitch": -2.0, field: value}
    if field == "preview":
        kw["preview_every"] = 1
    jdest, tdest = tmp_path / "jax.y4m", tmp_path / "torch.y4m"
    if field == "preview":
        kw[field] = str(tmp_path / "jax" / value)
    jrender(src, str(jdest), JRenderOptions(**kw))
    jerr = capsys.readouterr().err
    if field == "preview":
        kw[field] = str(tmp_path / "torch" / value)
    trender.render(src, str(tdest), trender.RenderOptions(**kw), device="cpu")
    assert capsys.readouterr().err == jerr  # --display's warning
    (jmeta, jframes), (tmeta, tframes) = read_frames(jdest), read_frames(tdest)
    assert (tmeta.width, tmeta.height, len(tframes)) == (jmeta.width, jmeta.height, 2)
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert_u8_close(tp, jp)
    if field == "preview":
        names = sorted(os.listdir(tmp_path / "jax" / value))
        assert names == sorted(os.listdir(tmp_path / "torch" / value)) == [
            "preview_000000.png", "preview_000001.png"]
        for name in names:
            assert_u8_close(cv2.imread(str(tmp_path / "torch" / value / name)),
                            cv2.imread(str(tmp_path / "jax" / value / name)))


def _render_actions(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    render = sub.choices["render"]
    return {a.dest: a for a in render._actions}


def test_cli_render_surface_matches_jax():
    """The JAX CLI's render options, plus ``--device`` (the port's form of
    ``JAX_PLATFORMS=cpu``)."""
    want = _render_actions(jcli.build_parser())
    got = _render_actions(tcli.build_parser())
    assert set(got) == set(want) | {"device"}
    assert (got["device"].default, got["device"].choices) == ("cuda", ("cuda", "cpu"))
    for dest, w in want.items():
        g = got[dest]
        for attr in ("option_strings", "default", "choices", "nargs", "const",
                     "required", "type"):
            wa, ga = getattr(w, attr), getattr(g, attr)
            if attr == "type" and callable(wa):
                wa, ga = getattr(wa, "__name__", wa), getattr(ga, "__name__", ga)
            assert ga == wa, (dest, attr)
    jsub = next(a for a in jcli.build_parser()._actions
                if isinstance(a, argparse._SubParsersAction))
    tsub = next(a for a in tcli.build_parser()._actions
                if isinstance(a, argparse._SubParsersAction))
    assert set(tsub.choices) == set(jsub.choices)


def test_cli_options_map_onto_render_options():
    args = tcli.build_parser().parse_args(
        ["render", "in.y4m", "out.y4m", "--stabilise", "smooth", "--preset", PRESET,
         "--analysis-scale", "0.5", "-h", "720", "--max-correction", "3"])
    o = tcli._render_options(args)
    assert (o.stabilise, o.preset, o.analysis_scale, o.height,
            o.max_correction_deg) == ("smooth", CameraPreset(PRESET), 0.5, 720, 3.0)
    assert set(vars(o)) == set(vars(JRenderOptions()))


def test_cli_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = tcli.main(["render", "synthetic://shaky?w=64&h=48&n=2", "o.y4m",
                    "--stabilise", "smooth"])
    assert rc == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_other_subcommands_run(tmp_path, capsys):
    """Every subcommand runs, and reports a pipeline error with exit 1 as
    the JAX CLI does: here ``calibrate`` of a missing ``.npz``, ``join``
    of a code with no chapters and ``probe`` of a missing file, while
    ``workflow tag`` writes its metadata."""
    missing = str(tmp_path / "corners.npz")
    assert tcli.main(["calibrate", missing, "--device", "cpu"]) == 1
    assert "corners.npz" in capsys.readouterr().err
    d = str(tmp_path)
    assert tcli.main(["join", "1234", "-o", str(tmp_path / "x.mp4"), "--directory", d]) == 1
    assert "no segments found for code '1234'" in capsys.readouterr().err
    assert tcli.main(["probe", str(tmp_path / "missing.mp4")]) == 1
    assert "unreadable source" in capsys.readouterr().err
    assert tcli.main(["workflow", "tag", "1234", "--directory", d, "--sets-json",
                      '[{"start": 0, "end": 1, "score": "21-19"}]']) == 0
    assert (tmp_path / "match_1234.json").exists()


@pytest.mark.parametrize("argv", [
    ["render", "synthetic://shaky?w=64&h=48&n=2", "o.y4m", "--device", "cuda"],
    ["compare", "synthetic://shaky?w=64&h=48&n=2", "o.y4m"],
    ["workflow", "stabilise", "0001"],
    ["calibrate", "corners.npz"],
])
def test_cli_asks_for_the_card_unless_told_cpu(monkeypatch, capsys, argv):
    """``--device cuda`` (the default) without a card exits 1: the CLI
    never moves to the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_render_on_the_cpu_matches_the_jax_cli(tmp_path, capsys):
    """``render --device cpu`` against the JAX CLI on the CPU: the same
    frames within one count and the same trajectory file."""
    src = "synthetic://shaky?w=320&h=240&n=8"
    jdest, tdest = str(tmp_path / "jax.y4m"), str(tmp_path / "torch.y4m")
    assert jcli.main(["render", src, jdest, "--stabilise", "smooth"]) == 0
    assert tcli.main(["render", src, tdest, "--stabilise", "smooth", "--device", "cpu"]) == 0
    jmeta, jframes = read_frames(jdest)
    tmeta, tframes = read_frames(tdest)
    assert (tmeta.width, tmeta.height, tmeta.num_frames) == \
        (jmeta.width, jmeta.height, jmeta.num_frames) == (jmeta.width, jmeta.height, 8)
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert_u8_close(tp, jp)
    ttraj = Trajectory.load(tdest + ".traj.npz")
    jtraj = JTrajectory.load(jdest + ".traj.npz")
    assert angle_deg(ttraj.rotations(), jtraj.rotations()).max() <= ANGLE_TOL_DEG


def _port_sources():
    files = sorted(p for p in (REPO / "video_annotator_tpu_torch").rglob("*.py")
                   if "_build" not in p.parts)
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Static scan: a site start-up hook may import jax before any test
    runs, so ``sys.modules`` cannot tell."""
    banned = ("jax", "video_annotator_tpu")
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in banned:
                    found.append(f"{path.relative_to(REPO)}: {name}")
    assert len(_port_sources()) > 20
    assert not found, found


def test_kernel_wrappers_refuse_other_devices():
    """CPU tensors take the plain versions; any other non-CUDA device
    raises instead of silently falling back."""
    from video_annotator_tpu_torch.camera import get_output_camera, get_preset_camera
    from video_annotator_tpu_torch.ops import lk_kernel, stage, warp_kernel

    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        stage.stage_u8(torch.empty((1, 40, 300), device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        lk_kernel.lk_level(torch.empty((2, 128, 256), dtype=torch.uint8, device=meta),
                           torch.empty((4, 6), device=meta),
                           torch.empty((4, 4), dtype=torch.int32, device=meta))
    in_cam = get_preset_camera(CameraPreset(PRESET), (64, 48))
    with pytest.raises(ValueError, match="no kernel"):
        warp_kernel.warp_planes_u8(torch.empty((1, 1, 48, 64), dtype=torch.uint8,
                                               device=meta),
                                   torch.eye(3)[None], get_output_camera(in_cam),
                                   in_cam, (8, 8))
    with pytest.raises(ValueError, match="no kernel"):
        warp_kernel.warp_planes_f32(torch.empty((2, 24, 32), device=meta), torch.eye(3),
                                    get_output_camera(in_cam), in_cam, (8, 8))
    with pytest.raises(ValueError, match="no kernel"):
        tso3.rotation_from_correlation(torch.empty((2, 3, 3), device=meta))
    plane = torch.empty((48, 64), dtype=torch.uint8, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        warp_kernel.warp_yuv(plane, plane[:24, :32], plane[:24, :32], torch.eye(3),
                             get_output_camera(in_cam), in_cam,
                             get_output_camera(in_cam), in_cam, (8, 8))
