"""Geometry of the torch port held against the JAX package on the CPU:
SO(3) maps, camera projection, output-camera fit, plane helpers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_annotator_tpu import camera as jcamera
from video_annotator_tpu import so3 as jso3
from video_annotator_tpu.ops import warp_pallas as jwp
from video_annotator_tpu.ops import warp_xla as jwx
from video_annotator_tpu_torch import camera as tcamera
from video_annotator_tpu_torch import so3 as tso3
from video_annotator_tpu_torch.ops import warp_plain as twp

ROT_ATOL = 1e-5
PX_ATOL = 1e-4


def to_port(jcam):
    leaves = {f: np.asarray(getattr(jcam, f)) for f in ("fx", "fy", "cx", "cy", "dist")}
    leaves.update(width=jcam.width, height=jcam.height, model=jcam.model)
    return tcamera.camera_from_numpy(leaves)


def assert_same_camera(tcam, jcam, rtol=0.0):
    for f in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(tcam, f), float(getattr(jcam, f)),
                                   rtol=rtol, err_msg=f)
    np.testing.assert_allclose(tcam.dist, np.asarray(jcam.dist), rtol=rtol)
    assert (tcam.width, tcam.height) == (jcam.width, jcam.height)
    assert tcam.model.value == jcam.model.value


def rotvecs(n, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-6, 0.05, 1.0, 3.0])
def test_exp_log_match_jax(scale):
    w = rotvecs(64, 0, scale)
    R_t = tso3.exp(torch.from_numpy(w)).numpy()
    R_j = np.asarray(jso3.exp(jnp.asarray(w)))
    np.testing.assert_allclose(R_t, R_j, atol=ROT_ATOL)
    np.testing.assert_allclose(tso3.log(torch.tensor(R_j)).numpy(),
                               np.asarray(jso3.log(jnp.asarray(R_j))), atol=ROT_ATOL)


def test_hat_vee_orthonormalize_project_match_jax():
    w = rotvecs(16, 1)
    np.testing.assert_array_equal(tso3.hat(torch.from_numpy(w)).numpy(),
                                  np.asarray(jso3.hat(jnp.asarray(w))))
    W = tso3.hat(torch.from_numpy(w))
    np.testing.assert_array_equal(tso3.vee(W).numpy(), w)
    R = np.asarray(jso3.exp(jnp.asarray(w)))
    noisy = (R + np.random.default_rng(2).normal(size=R.shape) * 1e-3).astype(np.float32)
    np.testing.assert_allclose(tso3.orthonormalize(torch.from_numpy(noisy)).numpy(),
                               np.asarray(jso3.orthonormalize(jnp.asarray(noisy))),
                               atol=ROT_ATOL)
    far = (R + np.random.default_rng(3).normal(size=R.shape) * 0.2).astype(np.float32)
    np.testing.assert_allclose(tso3.project(torch.from_numpy(far)).numpy(),
                               np.asarray(jso3.project(jnp.asarray(far))),
                               atol=ROT_ATOL)


def test_rotation_from_correlation_matches_jax():
    rng = np.random.default_rng(4)
    R = np.asarray(jso3.exp(jnp.asarray(rotvecs(8, 5))))
    p = rng.normal(size=(8, 50, 3)).astype(np.float32)
    q = np.einsum("bij,bnj->bni", R, p) + rng.normal(size=p.shape) * 0.01
    B = np.einsum("bni,bnj->bij", q, p).astype(np.float32)
    # Include the start that the all-ones power iteration cannot reach.
    B[0] = np.asarray(jso3.exp(jnp.asarray([np.pi * 0.999 / np.sqrt(2),
                                            -np.pi * 0.999 / np.sqrt(2), 0.0])))
    got = tso3.rotation_from_correlation(torch.from_numpy(B)).numpy()
    want = np.asarray(jso3.rotation_from_correlation(jnp.asarray(B)))
    np.testing.assert_allclose(got, want, atol=ROT_ATOL)


@pytest.mark.parametrize("lead", [(16,), (1,), (2, 5), (0,)])
def test_rotation_from_correlation_on_the_cpu_is_its_plain_twin(lead):
    """On a CPU tensor the solve launches no kernel and returns the plain
    twin's values exactly; the kernel is held to the twin on the card
    (``tests/test_torch_cuda.py``)."""
    B = torch.from_numpy(np.random.default_rng(sum(lead)).normal(
        size=(*lead, 3, 3)).astype(np.float32)) * 50
    before = tso3.WAHBA.launches
    got = tso3.rotation_from_correlation(B)
    assert tso3.WAHBA.launches == before
    assert got.shape == B.shape
    assert torch.equal(got, tso3.rotation_from_correlation_plain(B))


def test_from_euler_matches_jax():
    got = tso3.from_euler(0.1, -0.2, 0.3).numpy()
    want = np.asarray(jso3.from_euler(0.1, -0.2, 0.3))
    np.testing.assert_allclose(got, want, atol=ROT_ATOL)


@pytest.mark.parametrize("preset", list(jcamera.CameraPreset))
def test_presets_match_jax(preset):
    jcam = jcamera.get_preset_camera(preset, (640, 480))
    tcam = tcamera.get_preset_camera(tcamera.CameraPreset(preset.value), (640, 480))
    assert_same_camera(tcam, jcam)


@pytest.mark.parametrize("model", ["rectilinear", "fisheye", "equirect",
                                   "stereographic", "ball", "hammer", "pannini"])
def test_camera_from_dfov_matches_jax(model):
    jcam = jcamera.camera_from_dfov(145.8, (640, 480), jcamera.CameraModel(model))
    tcam = tcamera.camera_from_dfov(145.8, (640, 480), tcamera.CameraModel(model))
    assert_same_camera(tcam, jcam)


def test_camera_numpy_round_trip():
    jcam = jcamera.Camera.make(500.0, 501.0, 320.5, 239.5, 640, 480,
                               jcamera.CameraModel.FISHEYE,
                               dist=[0.01, -0.002, 0.0003, -0.00004])
    tcam = to_port(jcam)
    assert_same_camera(tcam, jcam)
    back = tcamera.camera_to_numpy(tcam)
    assert tcamera.camera_from_numpy(back) == tcam
    jback = jcamera.Camera.make(back["fx"], back["fy"], back["cx"], back["cy"],
                                back["width"], back["height"],
                                jcamera.CameraModel(back["model"]), dist=back["dist"])
    assert_same_camera(tcam, jback)


@pytest.mark.parametrize("dist", [None, [0.05, -0.01, 0.002, -0.0002]])
def test_fisheye_project_unproject_match_jax(dist):
    jcam = jcamera.Camera.make(300.0, 300.0, 319.5, 239.5, 640, 480,
                               jcamera.CameraModel.FISHEYE, dist=dist)
    tcam = to_port(jcam)
    rng = np.random.default_rng(7)
    px = np.stack([rng.uniform(0, 639, 500), rng.uniform(0, 479, 500)],
                  axis=-1).astype(np.float32)
    rays_t = tcam.unproject(torch.from_numpy(px))
    rays_j = np.asarray(jcam.unproject(jnp.asarray(px)))
    np.testing.assert_allclose(rays_t.numpy(), rays_j, rtol=1e-5, atol=1e-6)
    back_t = tcam.project(rays_t).numpy()
    np.testing.assert_allclose(back_t, px, atol=PX_ATOL * 10)
    np.testing.assert_allclose(back_t, np.asarray(jcam.project(jnp.asarray(rays_j))),
                               atol=PX_ATOL)


def test_unported_models_raise():
    """The panoramic models raised until this slice ported them: an
    equirect camera now unprojects and projects as the JAX one does (the
    other models: ``tests/test_torch_projection.py``)."""
    jcam = jcamera.camera_from_dfov(120.0, (64, 48), jcamera.CameraModel.EQUIRECT)
    cam = to_port(jcam)
    assert cam == tcamera.camera_from_dfov(120.0, (64, 48), tcamera.CameraModel.EQUIRECT)
    px = np.stack(np.meshgrid(np.arange(64.0), np.arange(48.0)), axis=-1).astype(np.float32)
    rays = cam.unproject(torch.from_numpy(px))
    np.testing.assert_allclose(rays.numpy(), np.asarray(jcam.unproject(jnp.asarray(px))),
                               atol=ROT_ATOL)
    np.testing.assert_allclose(cam.project(rays).numpy(), px, atol=PX_ATOL * 10)


@pytest.mark.parametrize("crop_borders", [False, True])
@pytest.mark.parametrize("zoom", [1.0, 1.0 / 1.2])
def test_get_output_camera_matches_jax(crop_borders, zoom):
    jin = jcamera.get_preset_camera(jcamera.CameraPreset.GOPRO_H4B_WIDE43_MEASURED,
                                    (3840, 2880))
    jout = jcamera.get_output_camera(jin, scale=1.0, crop_borders=crop_borders,
                                     zoom=zoom)
    tout = tcamera.get_output_camera(to_port(jin), scale=1.0,
                                     crop_borders=crop_borders, zoom=zoom)
    assert_same_camera(tout, jout, rtol=1e-5)


def test_plane_cameras_match_jax():
    jin = jcamera.get_preset_camera(jcamera.CameraPreset.GOPRO_H4B_WIDE43_MEASURED,
                                    (3840, 2880))
    tin = to_port(jin)
    assert_same_camera(twp.scaled_camera(tin, 0.5), jwx._scaled_camera(jin, 0.5))
    for level in (1, 2):
        assert_same_camera(twp.mip_camera(tin, level), jwp.mip_camera(jin, level))


@pytest.mark.parametrize("level", [1, 2])
def test_box_downsample_matches_jax(level):
    img = np.random.default_rng(8).integers(0, 256, size=(2, 37, 50)).astype(np.uint8)
    got = twp.box_downsample(torch.from_numpy(img), level).numpy()
    want = np.stack([np.asarray(jwp.box_downsample(jnp.asarray(f), level)) for f in img])
    np.testing.assert_array_equal(got, want)
