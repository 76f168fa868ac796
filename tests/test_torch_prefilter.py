"""The torch port's ``--prefilter auto`` (per-tile mip levels) on the CPU,
held against the JAX package: the level maps of luma and chroma against
``plan_warp(..., mip_levels=2).levels`` (equal), the plain per-tile-mip
warp against the Pallas kernel in interpret mode with the same plan, the
exactness of box levels under bilinear sampling on a linear ramp, the
correction angle each path probes against the JAX formula, and a
``--prefilter auto`` render against the port's own plain per-tile
composition with level maps equal to JAX's plans.

The port runs the TPU's per-tile rule on every device; the JAX CPU
fallback uses one global level instead (``mip_prefilter_level``), so the
render is not held to the JAX CPU render."""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_compare import to_port as port_trajectory
from test_torch_pipeline import PRESET, read_frames
from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from test_torch_warp import to_port
from video_annotator_tpu import so3 as jso3
from video_annotator_tpu.camera import (
    CameraModel,
    CameraPreset,
    camera_from_dfov,
    get_output_camera,
    get_preset_camera,
)
from video_annotator_tpu.pipeline import compare as jcompare
from video_annotator_tpu.pipeline import streaming as jstreaming
from video_annotator_tpu.ops.warp_pallas import plan_warp, warp_frame_pallas
from video_annotator_tpu.ops.warp_xla import _scaled_camera, warp_image_xla
from video_annotator_tpu.ops.warp_xla import compute_warp_map as jcompute_warp_map
from video_annotator_tpu_torch.camera import CameraPreset as TCameraPreset
from video_annotator_tpu_torch.ops import mip, warp_kernel
from video_annotator_tpu_torch.pipeline import compare as tcompare
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline import streaming as tstreaming
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory

# the module, which the package's own ``render`` function shadows
jrender_mod = importlib.import_module("video_annotator_tpu.pipeline.render")
PALLAS_ATOL = 1.5  # interior pixels: the Pallas kernel rounds levels to bytes, its own atan
RAMP_ATOL = 1e-3  # float levels of a linear ramp: exact up to float32 rounding
BUDGET_ATOL = 1e-4  # degrees: float32 rotations through two libraries


def fisheye_config():
    """A fisheye 128x96 output from 512x384 (every tile minifies)."""
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (512, 384))
    return in_cam, camera_from_dfov(100.0, (128, 96), CameraModel.FISHEYE), (96, 128), 4.0


def scaled_config(w=640, h=480):
    """``--scale 0.3`` of a cropped fit (levels 0 and 1 mixed)."""
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (w, h))
    out_cam = get_output_camera(in_cam, scale=0.3, crop_borders=True)
    size = (out_cam.height - out_cam.height % 2, out_cam.width - out_cam.width % 2)
    return in_cam, out_cam, size, 6.0


CONFIGS = {"fisheye": fisheye_config, "scaled": scaled_config,
           "scaled-1280": lambda: scaled_config(1280, 960)}


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
@pytest.mark.parametrize("plane", ["luma", "chroma"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_level_maps_equal_plan_warp(config, plane, interp):
    in_cam, out_cam, size, budget = CONFIGS[config]()
    if plane == "chroma":
        in_cam, out_cam = _scaled_camera(in_cam, 0.5), _scaled_camera(out_cam, 0.5)
        size = (size[0] // 2, size[1] // 2)
    plan = plan_warp(out_cam, in_cam, budget, size, mip_levels=2, interp=interp)
    got = mip.tile_levels(to_port(out_cam), to_port(in_cam), budget, size, interp)
    np.testing.assert_array_equal(got.levels.numpy(), plan.levels)
    assert got.levels.dtype == torch.uint8 and got.max_level == plan.mip_max
    if config != "fisheye" or plane == "luma":
        assert got.max_level >= 1  # the prefilter engages


@pytest.mark.parametrize("config", ["fisheye", "scaled"])
def test_plain_mip_warp_matches_pallas_interpret(config):
    """The plain per-tile-mip float warp against ``warp_frame_pallas`` in
    interpret mode with the same plan, on pixels whose source lies
    strictly inside (``tests/test_warp_pallas.py:501-512``)."""
    in_cam, out_cam, size, budget = CONFIGS[config]()
    plan = plan_warp(out_cam, in_cam, budget, size, mip_levels=2)
    levels = mip.tile_levels(to_port(out_cam), to_port(in_cam), budget, size)
    w, h = in_cam.width, in_cam.height
    img = np.round(np.random.default_rng(2).uniform(0, 255, (h, w))).astype(np.float32)
    rot = np.array(jso3.exp(jnp.array([0.01, -0.02, 0.015])))
    want = np.asarray(warp_frame_pallas(jnp.asarray(img), jnp.asarray(rot), plan, out_cam,
                                        in_cam, interpret=True))[: size[0], : size[1]]
    got = warp_kernel.warp_frame_f32(torch.from_numpy(img), torch.from_numpy(rot),
                                     to_port(out_cam), to_port(in_cam), size,
                                     levels=levels).numpy()
    cm = np.asarray(jcompute_warp_map(out_cam, in_cam, jnp.asarray(rot), size))
    inside = ((cm[..., 0] >= 1.5) & (cm[..., 0] <= w - 2.5)
              & (cm[..., 1] >= 1.5) & (cm[..., 1] <= h - 2.5))
    assert inside.mean() > 0.5
    assert np.abs(got - want)[inside].max() < PALLAS_ATOL


def test_mip_levels_match_the_kernel():
    """The planner's deepest level is what K1's mip mode takes: the plane
    and ``MIP_LEVELS`` levels in ``csrc/warp_modes.cu``, one (base, plane,
    pitch, rows, columns) argument group per level in its entry point."""
    src = (Path(warp_kernel.__file__).parent.parent / "csrc" / "warp_modes.cu").read_text()
    assert re.search(r"constexpr int MAX_LEVELS = (\d+);", src).group(1) == str(mip.MIP_LEVELS + 1)
    groups = re.findall(r"const void\* lv(\d),\s+long long lv\1_plane,\s+int lv\1_pitch", src)
    assert groups == [str(i) for i in range(1, mip.MIP_LEVELS + 1)]
    # 29 arguments, the level groups, then the band's rows and tile-row offset
    assert len(warp_kernel._MODES_ARGTYPES) == 29 + 5 * mip.MIP_LEVELS + 2
    levels = mip.TileLevels(torch.full((2, 1), mip.MIP_LEVELS + 1, dtype=torch.uint8),
                            mip.MIP_LEVELS + 1)
    with pytest.raises(ValueError, match="mip levels up to"):
        warp_kernel.level_stacks(torch.zeros((1, 1, 16, 16), dtype=torch.uint8), levels, 0.0)


def test_mip_exact_on_linear_ramp():
    """Box levels and bilinear sampling are exact for a linear image: any
    half-pixel error in the level transform shows as a shift against the
    unfiltered XLA oracle."""
    in_cam, out_cam, size, budget = scaled_config()
    levels = mip.tile_levels(to_port(out_cam), to_port(in_cam), budget, size)
    assert levels.max_level >= 1
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    img = 0.2 * xx + 0.15 * yy + 10.0
    rot = np.array(jso3.exp(jnp.array([0.01, -0.02, 0.015])))
    got = warp_kernel.warp_frame_f32(torch.from_numpy(img), torch.from_numpy(rot),
                                     to_port(out_cam), to_port(in_cam), size,
                                     levels=levels).numpy()
    ref = np.asarray(warp_image_xla(jnp.asarray(img), out_cam, in_cam, jnp.asarray(rot), size))
    cm = np.asarray(jcompute_warp_map(out_cam, in_cam, jnp.asarray(rot), size))
    inside = ((cm[..., 0] >= 1.5) & (cm[..., 0] <= 640 - 2.5)
              & (cm[..., 1] >= 1.5) & (cm[..., 1] <= 480 - 2.5))
    assert inside.mean() > 0.7
    assert np.abs(got - ref)[inside].max() < RAMP_ATOL


class Probed(Exception):
    """Raised by a recording FrameWarper once it has its budget."""


def record_budget(monkeypatch, module, seen, key):
    def warper(in_cam, out_cam, max_correction_deg, *args, **kwargs):
        seen[key] = float(max_correction_deg)
        raise Probed
    monkeypatch.setattr(module, "FrameWarper", warper)


SRC = "synthetic://shaky?w=160&h=120&n=6&seed=9"


def test_encode_budget_matches_jax(tmp_path, monkeypatch):
    """max(--max-correction, the largest correction + 0.5), from the same
    trajectory file, under --roll and --pitch."""
    from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions
    from video_annotator_tpu.pipeline.render import render as jrender

    kw = dict(stabilise="smooth", roll=7.0, pitch=-2.5, prefilter="auto")
    dest = str(tmp_path / "o.y4m")
    jrender(SRC, dest, JRenderOptions(analyse_only=True, **kw))
    seen = {}
    record_budget(monkeypatch, jrender_mod, seen, "jax")
    record_budget(monkeypatch, trender, seen, "torch")
    for fn, opts in ((jrender, JRenderOptions), (trender.render, trender.RenderOptions)):
        with pytest.raises(Probed):
            fn(SRC, dest, opts(encode_only=True, **kw),
               **({"device": "cpu"} if fn is trender.render else {}))
    assert seen["jax"] > 8.0  # the attitude pushes it past --max-correction
    assert abs(seen["torch"] - seen["jax"]) < BUDGET_ATOL


@pytest.mark.parametrize("lock", [False, True])
def test_streaming_budget_matches_jax(monkeypatch, lock):
    """--max-correction + the attitude (+ the lock's tilt + 2 degrees)."""
    from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions

    kw = dict(stabilise="smooth", streaming=True, horizon_lock=lock, roll=3.0, yaw=-4.0,
              max_correction_deg=5.0, prefilter="auto")
    seen = {}
    record_budget(monkeypatch, jstreaming, seen, "jax")
    record_budget(monkeypatch, tstreaming, seen, "torch")
    with pytest.raises(Probed):
        jstreaming.render_streaming(SRC, None, JRenderOptions(**kw))
    with pytest.raises(Probed):
        tstreaming.render_streaming(SRC, None, trender.RenderOptions(**kw), device="cpu")
    assert abs(seen["torch"] - seen["jax"]) < BUDGET_ATOL
    assert seen["torch"] > 5.0 + (2.0 if lock else 0.0)


def test_compare_budget_matches_jax(monkeypatch):
    """max(--max-correction, the largest rotation-cell correction + 0.5),
    the port fed the JAX analyser's trajectory."""
    seen, trajs = {}, {}
    analyse = jcompare.analyse
    monkeypatch.setattr(jcompare, "analyse",
                        lambda *a, **k: trajs.setdefault("rotation", analyse(*a, **k)))
    record_budget(monkeypatch, jcompare, seen, "jax")
    record_budget(monkeypatch, tcompare, seen, "torch")
    modes = ["none", "smooth+lock"]
    kw = dict(stabilise_radius=2, preset=None, input_dfov=120.0, roll=8.0, prefilter="auto")
    with pytest.raises(Probed):
        jcompare.render_compare(SRC, None, modes, jrender_mod.RenderOptions(**kw))
    monkeypatch.setattr(tcompare, "analyse", lambda *a, **k: port_trajectory(trajs["rotation"]))
    with pytest.raises(Probed):
        tcompare.render_compare(SRC, None, modes, trender.RenderOptions(**kw), device="cpu")
    assert seen["jax"] > 8.0
    assert abs(seen["torch"] - seen["jax"]) < BUDGET_ATOL


def test_render_prefilter_is_the_plain_per_tile_composition(tmp_path):
    """``render --prefilter auto --scale 0.3 --crop``: every written frame
    equals the plain per-tile-mip warp of its source frame, whose level
    maps equal JAX's plans for the render's cameras and budget."""
    src = "synthetic://shaky?w=320&h=240&n=3&seed=3"
    opts = trender.RenderOptions(prefilter="auto", scale=0.3, crop_borders=True, roll=2.0,
                                 preset=TCameraPreset(PRESET))
    dest = tmp_path / "pre.y4m"
    trender.render(src, str(dest), opts, device="cpu")
    _, frames = read_frames(dest)
    in_cam, out_cam = trender.build_cameras(trender.VideoMeta(320, 240, 30, 3), opts)
    corr = trender.compute_corrections(
        Trajectory(params=np.zeros((3, 3)), width=320, height=240), opts, "cpu")
    budget = max(opts.max_correction_deg, trender.max_rotation_deg(corr) + 0.5)
    warper = trender.FrameWarper(in_cam, out_cam, budget, prefilter=True, device="cpu")
    assert warper.levels[0].max_level >= 1
    jin = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (320, 240))
    jout = get_output_camera(jin, scale=0.3, crop_borders=True)
    for levels, (jo, ji), size in zip(
            warper.levels, ((jout, jin), (_scaled_camera(jout, 0.5), _scaled_camera(jin, 0.5))),
            ((warper.out_h, warper.out_w), (warper.out_h // 2, warper.out_w // 2))):
        plan = plan_warp(jo, ji, budget, size, mip_levels=2)
        np.testing.assert_array_equal(levels.levels.numpy(), plan.levels)
    from video_annotator_tpu_torch.io.synthetic import SyntheticSource

    for t, (planes, written) in enumerate(zip(SyntheticSource.from_uri(src), frames)):
        rot = torch.from_numpy(corr[t])
        want = [warp_kernel.warp_planes_u8_plain(
            torch.from_numpy(np.array(p))[None, None], rot[None], o, i, s, b,
            levels=lv)[0, 0] for p, (o, i, s, b, lv) in zip(planes, [
                (warper.out_cam, warper.in_cam, (warper.out_h, warper.out_w), 0.0,
                 warper.levels[0])] + [(warper.out_half, warper.in_half,
                                        (warper.out_h // 2, warper.out_w // 2), 128.0,
                                        warper.levels[1])] * 2)]
        for w_, g in zip(want, written):
            np.testing.assert_array_equal(g, w_.numpy())
