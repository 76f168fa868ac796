"""The torch port's output projections on the CPU, held against the JAX
package: ``project``/``unproject`` of the panoramic models (and the
fisheye) against the JAX ``Camera``, the float64 unprojection against the
JAX planner's ``unproject_np``, the warp map and the float and uint8
warps for each output that is not rectilinear against the XLA oracle and
the JAX ``FrameWarper``, the cameras' numpy round trip, and ``render
--projection`` against the JAX render. One test per property, one case
per model."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_pipeline import assert_u8_close, read_frames
from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from test_torch_warp import FLOAT_ATOL, to_port
from video_annotator_tpu import camera as jcamera
from video_annotator_tpu import so3 as jso3
from video_annotator_tpu.ops.warp_xla import compute_warp_map as jcompute_warp_map
from video_annotator_tpu.ops.warp_xla import warp_image_xla
from video_annotator_tpu.pipeline.render import FrameWarper as JFrameWarper
from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions
from video_annotator_tpu.pipeline.render import render as jrender
from video_annotator_tpu_torch import camera as tcamera
from video_annotator_tpu_torch.ops import warp_kernel, warp_plain
from video_annotator_tpu_torch.pipeline import render as trender

PANORAMIC = ("equirect", "stereographic", "mercator", "ball", "hammer", "sinusoidal",
             "cylindrical", "pannini")
OUTPUTS = PANORAMIC + ("fisheye",)
RAY_ATOL = 1e-5  # float32 trigonometry in another library, directions of norm 1
PX_ATOL = 2e-3  # projected pixels: the same on an f = 30-60 px chart
F64_ATOL = 1e-9  # float64 unprojection against numpy's
DFOV = 150.0  # past 90 degrees off the axis: the lon/lat charts wrap, ball's rim shows


def jax_camera(model, size=(96, 72), dfov=DFOV):
    return jcamera.camera_from_dfov(dfov, size, jcamera.CameraModel(model))


def pixels(w, h, n, seed):
    """Pixels over the whole canvas and a margin beyond it (invalid
    regions of the bounded charts included)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.2 * w, 1.2 * w, n), rng.uniform(-0.2 * h, 1.2 * h, n)],
                    axis=-1).astype(np.float32)


def input_camera(w=160, h=120):
    return jcamera.get_preset_camera(jcamera.CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (w, h))


ROT = np.array(jso3.exp(jnp.array([0.03, -0.02, 0.05])))


@pytest.mark.parametrize("model", OUTPUTS)
def test_unproject_matches_jax(model):
    jcam = jax_camera(model)
    px = pixels(96, 72, 600, 1)
    got = to_port(jcam).unproject(torch.from_numpy(px)).numpy()
    want = np.asarray(jcam.unproject(jnp.asarray(px)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RAY_ATOL)


@pytest.mark.parametrize("model", OUTPUTS)
def test_unproject_float64_matches_planner(model):
    """The level planner's float64 rays: ``unproject_np``, the fisheye
    clipped below 90 degrees as it clips."""
    jcam = jax_camera(model)
    px = pixels(96, 72, 600, 2).astype(np.float64)
    max_theta = np.pi / 2 - 1e-3 if model == "fisheye" else None
    got = to_port(jcam).unproject(torch.from_numpy(px), max_theta=max_theta).numpy()
    want = jcamera.unproject_np(jcam, px[:, 1], px[:, 0])
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=F64_ATOL)


@pytest.mark.parametrize("model", OUTPUTS)
def test_project_matches_jax(model):
    jcam = jax_camera(model)
    rng = np.random.default_rng(3)
    rays = rng.normal(size=(600, 3)).astype(np.float32)
    rays[:, 2] = np.abs(rays[:, 2]) + 0.2  # in front: the fisheye's perspective divide
    got = to_port(jcam).project(torch.from_numpy(rays)).numpy()
    want = np.asarray(jcam.project(jnp.asarray(rays)))
    np.testing.assert_allclose(got, want, atol=PX_ATOL)


@pytest.mark.parametrize("model", OUTPUTS)
def test_ray_grid_is_made_once_per_camera(model):
    """The ray grid K1 reads: the rays ``compute_warp_map`` rotates, planar
    and contiguous, computed once per camera, size and device and then
    reused by every launch."""
    cam, cpu = to_port(jax_camera(model)), torch.device("cpu")
    got = warp_kernel.ray_grid_planar(cam, (72, 96), cpu)
    assert got.shape == (3, 72, 96) and got.is_contiguous()
    assert torch.equal(got, warp_plain.ray_grid(cam, (72, 96), cpu).permute(2, 0, 1))
    assert warp_kernel.ray_grid_planar(cam, (72, 96), cpu) is got
    assert warp_kernel.ray_grid_planar(cam, (36, 48), cpu).shape == (3, 36, 48)


@pytest.mark.parametrize("model", OUTPUTS)
def test_camera_crosses_numpy_both_ways(model):
    jcam = jax_camera(model)
    tcam = to_port(jcam)
    assert tcam.model.value == model
    back = tcamera.camera_from_numpy(tcamera.camera_to_numpy(tcam))
    assert back == tcam
    leaves = tcamera.camera_to_numpy(tcam)
    jback = jcamera.Camera.make(leaves["fx"], leaves["fy"], leaves["cx"], leaves["cy"],
                                leaves["width"], leaves["height"],
                                jcamera.CameraModel(leaves["model"]), dist=leaves["dist"])
    assert jback.model == jcam.model and float(jback.fx) == float(jcam.fx)


@pytest.mark.parametrize("model", OUTPUTS)
def test_warp_map_matches_jax(model):
    jin, jout = input_camera(), jax_camera(model)
    got = warp_plain.compute_warp_map(to_port(jout), to_port(jin), torch.from_numpy(ROT))
    want = np.asarray(jcompute_warp_map(jout, jin, jnp.asarray(ROT)))
    inside = (np.abs(want) < 1e5).all(axis=-1)  # behind the camera: pinned alike
    np.testing.assert_array_equal((np.abs(got.numpy()) < 1e5).all(axis=-1), inside)
    np.testing.assert_allclose(got.numpy()[inside], want[inside], atol=PX_ATOL)


@pytest.mark.parametrize("model", OUTPUTS)
def test_float_warp_matches_xla(model):
    jin, jout = input_camera(), jax_camera(model)
    img = np.round(np.random.default_rng(4).uniform(0, 255, (120, 160))).astype(np.float32)
    want = np.asarray(warp_image_xla(jnp.asarray(img), jout, jin, jnp.asarray(ROT)))
    got = warp_kernel.warp_frame_f32(torch.from_numpy(img), torch.from_numpy(ROT),
                                     to_port(jout), to_port(jin), (72, 96)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FLOAT_ATOL)


@pytest.mark.parametrize("model", OUTPUTS)
def test_u8_warp_matches_jax_framewarper(model):
    jin, jout = input_camera(), jax_camera(model)
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (120, 160)).astype(np.uint8)
    u = rng.integers(0, 256, (60, 80)).astype(np.uint8)
    v = rng.integers(0, 256, (60, 80)).astype(np.uint8)
    want = JFrameWarper(jin, jout, 8.0).warp_yuv(jnp.asarray(y), jnp.asarray(u),
                                                 jnp.asarray(v), jnp.asarray(ROT))
    got = trender.FrameWarper(to_port(jin), to_port(jout)).warp_yuv(
        torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(ROT))
    for g, w in zip(got, want):
        assert_u8_close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("model", OUTPUTS)
def test_render_projection_matches_jax(tmp_path, model):
    """``render --projection`` end to end (no stabilisation: a rolled and
    pitched attitude, so no analyser runs) against the JAX render."""
    src = "synthetic://shaky?w=160&h=120&n=3&seed=6"
    kw = dict(projection=model, roll=4.0, pitch=-3.0, input_dfov=120.0)
    jdest, tdest = tmp_path / "jax.y4m", tmp_path / "torch.y4m"
    jrender(src, str(jdest), JRenderOptions(**kw))
    trender.render(src, str(tdest), trender.RenderOptions(**kw), device="cpu")
    jmeta, jframes = read_frames(jdest)
    tmeta, tframes = read_frames(tdest)
    assert (tmeta.width, tmeta.height, tmeta.num_frames) == \
        (jmeta.width, jmeta.height, jmeta.num_frames)
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert_u8_close(tp, jp)
