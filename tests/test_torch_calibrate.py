"""The port's calibration fit (``calibrate.py``) against the JAX package's
on the CPU: the projection and its gradients, one Levenberg-Marquardt
iteration, and whole fits on the synthetic boards of
``tests/test_calibrate.py``.

Adam's iterates are not bit for bit optax's (float32 sums in another
order), so the fits are held by their results: intrinsics within 1e-3
relative of JAX's, the RMS within 0.01 px, and both within
``tests/test_calibrate.py``'s tolerances of the truth. The fits run
fewer Adam steps than those tests where the LM polish still converges,
the same count in both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_calibrate import _synthetic_views
from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from video_annotator_tpu import calibrate as jcal
from video_annotator_tpu import so3 as jso3
from video_annotator_tpu.camera import CameraModel as JCameraModel
from video_annotator_tpu.camera import camera_from_dfov as jcamera_from_dfov
from video_annotator_tpu_torch import calibrate as tcal
from video_annotator_tpu_torch.camera import CameraModel

MODELS = {"fisheye": (JCameraModel.FISHEYE, CameraModel.FISHEYE),
          "rectilinear": (JCameraModel.RECTILINEAR, CameraModel.RECTILINEAR)}
INTRINSICS_RTOL = 1e-3
RMS_ATOL = 0.01  # px


def board(origin_at_corner=False, square=1.0):
    xs, ys = np.meshgrid(np.arange(9), np.arange(6))
    if not origin_at_corner:
        xs, ys = xs - 4, ys - 2.5
    return np.stack([xs.ravel(), ys.ravel(), np.zeros(54)], axis=1) * square


def params(views, seed, dist=(0.03, -0.01, 0.002, -0.001)):
    rng = np.random.default_rng(seed)
    return {"fx": 300.0, "fy": 302.0, "cx": 321.0, "cy": 238.0, "dist": np.asarray(dist),
            "rvec": rng.normal(size=(views, 3)) * 0.25,
            "tvec": np.stack([rng.normal(size=views) * 0.3, rng.normal(size=views) * 0.3,
                              3.0 + rng.uniform(size=views)], axis=1)}


def as_jax(p):
    return {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in p.items()}


def as_torch(p):
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in p.items()}


def ulps(want, n=2):
    """``n`` float32 spacings at the largest magnitude of ``want``."""
    return n * float(np.spacing(np.float32(np.abs(want).max())))


@pytest.mark.parametrize("aspect", [None, 1.01])
@pytest.mark.parametrize("model", MODELS)
def test_project_matches_jax(model, aspect):
    """Float32 pixels to within two float32 spacings of the largest
    coordinate (6.1e-5 px at 600 px): the same operations, summed in
    another order."""
    jm, tm = MODELS[model]
    p, obj = params(5, 0), board()
    want = np.asarray(jcal._project(as_jax(p), jnp.asarray(obj, jnp.float32), jm, aspect))
    got = tcal._project(as_torch(p), torch.tensor(obj, dtype=torch.float32), tm, aspect).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ulps(want))


def test_project_gradients_stay_finite_on_the_optical_axis():
    """A corner-origin board facing the camera puts a point at r = 0: the
    double-where keeps its gradients finite, equal to JAX's."""
    obj = board(origin_at_corner=True, square=0.03)
    p = params(2, 1)
    p["rvec"][:] = 0.0
    p["tvec"][:] = [0.0, 0.0, 0.5]
    jp, tp = as_jax(p), as_torch(p)
    jobj = jnp.asarray(obj, jnp.float32)

    def jloss(q):
        return jnp.sum(jcal._project(q, jobj, JCameraModel.FISHEYE) ** 2)

    want = jax.grad(jloss)(jp)
    for v in tp.values():
        v.requires_grad_(True)
    loss = (tcal._project(tp, torch.tensor(obj, dtype=torch.float32), CameraModel.FISHEYE)
            ** 2).sum()
    loss.backward()
    for k in p:
        g = tp[k].grad.numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want[k]).max()), err_msg=k)


def test_flat_parameters_follow_ravel_pytree():
    """The flat vector's layout is ``ravel_pytree``'s, so a fix mask means
    the same entries in both packages."""
    from jax.flatten_util import ravel_pytree

    p = params(3, 2)
    want, _ = ravel_pytree(as_jax(p))
    got = tcal._ravel(p, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tcal._unravel(got, 3)
    for k in p:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(p[k], np.float32))


@pytest.mark.parametrize("model", MODELS)
def test_one_lm_iteration_matches_jax(model):
    """One LM iteration from the same perturbed parameters: the same
    float64 solve on float32 residuals and ``jacfwd`` Jacobians."""
    jm, tm = MODELS[model]
    truth, obj = params(6, 3, dist=(0.02, -0.005, 0.0, 0.0)), board()
    truth["tvec"][:, 2] += 6.0  # boards inside a pinhole camera's view
    img = np.asarray(jcal._project(as_jax(truth), jnp.asarray(obj, jnp.float32), jm))
    start = {k: np.asarray(v, np.float64) * (1.0 + 0.003 * (i % 3 - 1))
             for i, (k, v) in enumerate(truth.items())}
    start["dist"] = np.zeros(4)
    jobj, jimg = jnp.asarray(obj, jnp.float32), jnp.asarray(img, jnp.float32)
    want = jcal._lm_refine(as_jax(start), jobj, jimg, jm, iters=1)
    got = tcal._unravel(tcal._lm_refine(
        tcal._ravel(start, 6), torch.tensor(obj, dtype=torch.float32),
        torch.tensor(img), tm, iters=1), 6)
    for k in truth:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-5, err_msg=k)
    assert abs(float(got["fx"]) - float(start["fx"])) > 0.1  # the iteration moved


def fit_both(obj, img, size, model, steps, **kw):
    jm, tm = MODELS[model]
    jcam, jrms = jcal.calibrate(obj, img, size, jm, steps=steps, **kw)
    tcam, trms = tcal.calibrate(obj, img, size, tm, steps=steps, device="cpu", **kw)
    got = np.array([tcam.fx, tcam.fy, tcam.cx, tcam.cy])
    want = np.array([float(jcam.fx), float(jcam.fy), float(jcam.cx), float(jcam.cy)])
    np.testing.assert_allclose(got, want, rtol=INTRINSICS_RTOL)
    assert abs(trms - jrms) <= RMS_ATOL, (trms, jrms)
    return tcam, trms, jcam, jrms


def test_fisheye_fit_matches_jax():
    """test_calibrate.py::test_calibrate_recovers_fisheye_intrinsics."""
    true = {"fx": jnp.float32(300.0), "fy": jnp.float32(302.0), "cx": jnp.float32(321.0),
            "cy": jnp.float32(238.0), "dist": jnp.asarray([0.03, -0.01, 0.0, 0.0], jnp.float32)}
    obj = board()
    img = np.array(_synthetic_views(true, obj, n_views=12, model=JCameraModel.FISHEYE))
    img += np.random.default_rng(1).normal(size=img.shape) * 0.05
    for cam, rms in [fit_both(obj, img, (640, 480), "fisheye", 1500)[:2],
                     fit_both(obj, img, (640, 480), "fisheye", 1500)[2:]]:
        assert rms < 0.5
        for v, t in zip((cam.fx, cam.fy, cam.cx, cam.cy), (300.0, 302.0, 321.0, 238.0)):
            assert abs(float(v) - t) < 3.0


def test_close_corner_origin_board_fit_matches_jax():
    """test_calibrate.py::test_calibrate_corner_origin_board_close_range:
    a point on the optical axis and boards under one diagonal away."""
    cam = jcamera_from_dfov(120.0, (640, 480), JCameraModel.FISHEYE)
    rng = np.random.default_rng(0)
    obj = board(origin_at_corner=True, square=0.03)
    imgs = []
    for _ in range(10):
        R = np.asarray(jso3.exp(jnp.asarray(rng.normal(size=3) * 0.2)))
        t = np.array([rng.uniform(-0.06, 0.06), rng.uniform(-0.06, 0.06),
                      rng.uniform(0.35, 0.8)])
        imgs.append(np.asarray(cam.project(jnp.asarray(obj @ R.T + t))))
    img = np.stack(imgs) + rng.normal(size=(10, 54, 2)) * 0.1
    tcam, trms, _, _ = fit_both(obj, img, (640, 480), "fisheye", 1500)
    assert np.isfinite(trms) and trms < 0.5
    assert abs(tcam.fx - float(cam.fx)) < 4.0 and abs(tcam.cx - float(cam.cx)) < 4.0


def test_fix_flags_match_jax():
    """test_calibrate.py::test_calibrate_fix_flags: pinned parameters stay
    exactly at their values."""
    w, h = 640, 480
    true = {"fx": jnp.float32(301.0), "fy": jnp.float32(301.0),
            "cx": jnp.float32((w - 1) / 2.0), "cy": jnp.float32((h - 1) / 2.0),
            "dist": jnp.asarray([0.0, -0.01, 0.0, 0.0], jnp.float32)}
    obj = board()
    img = _synthetic_views(true, obj, n_views=12, model=JCameraModel.FISHEYE, seed=5)
    tcam, trms, _, _ = fit_both(obj, img, (w, h), "fisheye", 1500, fix_aspect_ratio=1.0,
                                fix_principal_point=True, fix_k=(True, False, True, True))
    assert trms < 0.5
    assert tcam.fx == tcam.fy
    assert (tcam.cx, tcam.cy) == ((w - 1) / 2.0, (h - 1) / 2.0)
    assert tcam.dist[0] == tcam.dist[2] == tcam.dist[3] == 0.0
    assert abs(tcam.dist[1] + 0.01) < 5e-3 and abs(tcam.fx - 301.0) < 3.0


def test_rectilinear_fit_matches_jax():
    """test_calibrate.py::test_standard_model_fits_radial_distortion: the
    cv2 seed (initCameraMatrix2D, solvePnP), then Brown k1..k3."""
    w, h = 640, 480
    true = {"fx": 400.0, "fy": 402.0, "cx": 319.0, "cy": 241.0,
            "dist": np.asarray([-0.25, 0.08, 0.0, 0.0])}
    rng = np.random.default_rng(2)
    true["rvec"] = rng.normal(size=(12, 3)) * 0.25
    true["tvec"] = np.stack([rng.normal(size=12) * 0.4, rng.normal(size=12) * 0.4,
                             9.0 + 3.0 * rng.uniform(size=12)], axis=1)
    obj = board()
    img = np.asarray(jcal._project(as_jax(true), jnp.asarray(obj, jnp.float32),
                                   JCameraModel.RECTILINEAR))
    img = img + np.random.default_rng(1).normal(size=img.shape) * 0.05
    tcam, trms, jcam, _ = fit_both(obj, img, (w, h), "rectilinear", 1500)
    assert trms < 0.5 and abs(tcam.fx - 400.0) < 4.0
    assert abs(tcam.dist[0] + 0.25) < 0.03 and abs(tcam.dist[1] - 0.08) < 0.05
    np.testing.assert_allclose(tcam.dist[:3], np.asarray(jcam.dist)[:3], atol=1e-3)


def test_rectilinear_seed_falls_back_to_the_generic_init(monkeypatch):
    """When cv2's seed raises, the fit starts from the generic guess, as
    the JAX package's ``except`` does; it still runs."""
    import cv2

    def broken(*args, **kwargs):
        raise cv2.error("no homography")

    monkeypatch.setattr(cv2, "initCameraMatrix2D", broken)
    obj = board()
    img = np.asarray(jcal._project(as_jax(params(4, 6, dist=(0, 0, 0, 0))),
                                   jnp.asarray(obj, jnp.float32), JCameraModel.RECTILINEAR))
    cam, rms = tcal.calibrate(obj, img, (640, 480), CameraModel.RECTILINEAR, steps=10,
                              device="cpu")
    assert np.isfinite(rms) and cam.model == CameraModel.RECTILINEAR
