"""Camera intrinsic calibration by differentiable bundle adjustment.

Port of ``video_annotator_tpu/calibrate.py``, the counterpart of the
reference's OpenCV-sample calibration tool
(``opencv/camera_calibration/camera_calibration.cpp``: chessboard views ->
``fisheye::calibrate`` at ``:574`` / ``calibrateCameraRO`` at ``:587-589``,
reporting the RMS reprojection error at ``:488,600-606``). The projection
is plain torch (:func:`_project`), so the fit is gradient-based nonlinear
least squares over (fx, fy, cx, cy, k1..k4, per-view pose): Adam, written
out on one flat parameter vector, then a Levenberg-Marquardt polish on
``torch.func.jacfwd`` Jacobians with a float64 numpy solve.

The parameters live in one flat float32 vector in the JAX package's
``ravel_pytree`` order (``cx, cy, dist, fx, fy, rvec, tvec``), so the fix
masks and the per-parameter step scales are vectors of the same layout.

The host half (pattern detection, the settings file, the FileStorage
output) is cv2, as in the JAX package. The fit runs on the caller's
device (``cuda`` by default: tiny steps, bound by launches there); the
post-fit undistorted views warp through kernel K1's float one-frame mode
on a card and through ``ops/warp_plain.py::warp_image`` on the CPU.

Input: a video to detect a chessboard in (the reference tool's workflow;
its settings point ``Input`` at GoPro footage of a 9x6 board,
``opencv/camera_calibration/in_VID5.xml``), an image list, or an ``.npz``
with ``object_points`` (N, 3) board coordinates and ``image_points``
(V, N, 2) pre-extracted detections per view.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.camera import Camera, CameraModel
from video_annotator_tpu_torch.ops import cuda_lib

# Adam (optax's defaults) and the schedule exponential_decay(0.05, 1000, 0.5).
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
LR0 = 0.05
LR_HALF_LIFE = 1000
PIXEL_STEP = 100.0  # fx, fy, cx, cy move at pixel scale
DEPTH_MIN = 1e-2


class PatternType(enum.Enum):
    """Calibration target families the reference tool supports
    (``camera_calibration.cpp:22``, detection switch ``:356-363``)."""

    CHESSBOARD = "CHESSBOARD"
    CIRCLES_GRID = "CIRCLES_GRID"
    ASYMMETRIC_CIRCLES_GRID = "ASYMMETRIC_CIRCLES_GRID"


def _layout(views: int):
    """(name, shape) of each parameter, in ``ravel_pytree``'s key order."""
    return (("cx", ()), ("cy", ()), ("dist", (4,)), ("fx", ()), ("fy", ()),
            ("rvec", (views, 3)), ("tvec", (views, 3)))


def _unravel(flat: torch.Tensor, views: int) -> dict:
    """Views of the flat parameter vector, by name."""
    out, at = {}, 0
    for name, shape in _layout(views):
        n = int(np.prod(shape, dtype=np.int64))
        out[name] = flat[at:at + n].reshape(shape)
        at += n
    return out


def _ravel(params: dict, views: int, device=None) -> torch.Tensor:
    return torch.cat([torch.as_tensor(np.asarray(params[name], np.float32),
                                      device=device).reshape(-1)
                      for name, _ in _layout(views)])


def _project(params: dict, obj_pts: torch.Tensor, model: CameraModel,
             aspect_ratio: Optional[float] = None) -> torch.Tensor:
    """Project (N, 3) board points through each view's pose and the
    intrinsics: (V, N, 2) pixels.

    ``aspect_ratio``: when set, fx is tied to ``aspect_ratio * fy`` (the
    reference's CALIB_FIX_ASPECT_RATIO, ``camera_calibration.cpp:137-138``)
    and ``params["fx"]`` is unused."""
    fx, fy, cx, cy = params["fx"], params["fy"], params["cx"], params["cy"]
    if aspect_ratio is not None:
        fx = aspect_ratio * fy
    dist = params["dist"]
    R = so3.exp(params["rvec"])  # (V, 3, 3)
    # Full float32 products, never TF32: sum_j R[v, i, j] obj[n, j].
    cam_pts = (R[:, None, :, :] * obj_pts[None, :, None, :]).sum(-1) + params["tvec"][:, None, :]
    # Clamp the depth: an iterate that pushes a board point to z <= 0 must
    # give a large finite residual, not a NaN that poisons every parameter.
    z = torch.clamp(cam_pts[..., 2], min=DEPTH_MIN)
    x = cam_pts[..., 0] / z
    y = cam_pts[..., 1] / z
    if model == CameraModel.FISHEYE:
        # Double-where: a board point on the optical axis (r = 0) must not
        # leak NaN through sqrt'(0) into the gradients; torch.where alone,
        # like jnp.where, differentiates both branches.
        r2 = x * x + y * y
        on_axis = r2 < 1e-18
        r = torch.sqrt(torch.where(on_axis, torch.ones_like(r2), r2))
        theta = torch.atan(r)
        t2 = theta * theta
        theta_d = theta * (1.0 + t2 * (dist[0] + t2 * (dist[1] + t2 * (dist[2] + t2 * dist[3]))))
        s = torch.where(on_axis, torch.ones_like(r2), theta_d / r)
        x, y = x * s, y * s
    else:
        # Brown radial k1..k3 (the reference's standard model with
        # AssumeZeroTangentialDistortion); dist[3] stays unused.
        r2 = x * x + y * y
        radial = 1.0 + r2 * (dist[0] + r2 * (dist[1] + r2 * dist[2]))
        x, y = x * radial, y * radial
    u = fx * x + cx
    v = fy * y + cy
    return torch.stack([u, v], dim=-1)


def _rectilinear_seed(object_points, image_points, w, h, rvec0, tvec0):
    """calibrateCameraRO's seed: planar-homography intrinsics, then PnP per
    view (in place on ``rvec0``/``tvec0``). Returns (fx0, fy0)."""
    import cv2

    v = image_points.shape[0]
    objs = [object_points.astype(np.float32)] * v
    imgs = [image_points[i].astype(np.float32).reshape(-1, 1, 2) for i in range(v)]
    K0 = cv2.initCameraMatrix2D(objs, imgs, (w, h))
    fx0, fy0 = float(K0[0, 0]), float(K0[1, 1])
    for i in range(v):
        ok, rv, tv = cv2.solvePnP(objs[i], imgs[i], K0, None, flags=cv2.SOLVEPNP_ITERATIVE)
        if ok:
            rvec0[i] = rv.ravel()
            tvec0[i] = tv.ravel()
    return fx0, fy0


def calibrate(
    object_points: np.ndarray,  # (N, 3)
    image_points: np.ndarray,  # (V, N, 2)
    image_size: Tuple[int, int],
    model: CameraModel = CameraModel.FISHEYE,
    steps: int = 4000,
    fix_aspect_ratio: Optional[float] = None,
    fix_principal_point: bool = False,
    fix_k: Sequence[bool] = (False, False, False, False),
    full_output: bool = False,
    device="cuda",
):
    """Fit intrinsics + per-view poses; returns (camera, rms_error_px),
    plus the per-view extrinsics (V, 6) [rvec | tvec] when
    ``full_output`` (the reference's saveCameraParams writes them,
    ``camera_calibration.cpp:640-668``).

    The ``fix_*`` knobs mirror the reference's calibration flags
    (``camera_calibration.cpp:130-147``): CALIB_FIX_ASPECT_RATIO pins
    fx = ratio * fy, CALIB_FIX_PRINCIPAL_POINT pins (cx, cy) at the image
    center, CALIB_FIX_K1..K4 pin distortion coefficients at zero. Fixed
    entries are masked out of both optimizers' steps.

    Adam runs ``steps`` steps at learning rate 0.05 * 0.5^(i / 1000); its
    updates are scaled by 100 for fx, fy, cx, cy, by the fix mask, and by
    0 for the distortion during the first half (whose gradients still
    enter Adam's moments, as in optax)."""
    dev = torch.device(device)
    v = image_points.shape[0]
    w, h = image_size
    obj = torch.tensor(np.asarray(object_points, np.float32), device=dev)
    img = torch.tensor(np.asarray(image_points, np.float32), device=dev)

    # Principal point at center, focal from a 90-degree dfov guess, boards
    # about one board diagonal in front of the camera.
    diag = float(np.linalg.norm(object_points.max(0) - object_points.min(0)))
    fx0 = fy0 = 0.8 * w
    rvec0 = np.zeros((v, 3), np.float32)
    tvec0 = np.tile(np.asarray([0.0, 0.0, max(diag, 1.0)], np.float32), (v, 1))
    if model == CameraModel.RECTILINEAR:
        # The pinhole model's X/z geometry is unbounded and gradient
        # descent from the generic guess diverges: seed as calibrateCameraRO.
        try:
            fx0, fy0 = _rectilinear_seed(object_points, image_points, w, h, rvec0, tvec0)
        except Exception:
            pass  # the generic init, as the JAX package falls back
    p = _ravel({"fx": fx0, "fy": fy0, "cx": (w - 1) / 2.0, "cy": (h - 1) / 2.0,
                "dist": np.zeros(4), "rvec": rvec0, "tvec": tvec0}, v, dev)

    # 0/1 mask in the parameters' layout: fixed entries never move (the LM
    # polish zeroes the same Jacobian columns).
    mask = _ravel({
        "fx": 0.0 if fix_aspect_ratio is not None else 1.0, "fy": 1.0,
        "cx": 0.0 if fix_principal_point else 1.0,
        "cy": 0.0 if fix_principal_point else 1.0,
        "dist": [0.0 if f else 1.0 for f in fix_k],
        "rvec": np.ones((v, 3)), "tvec": np.ones((v, 3))}, v, dev)
    pixel = _ravel({"fx": PIXEL_STEP, "fy": PIXEL_STEP, "cx": PIXEL_STEP, "cy": PIXEL_STEP,
                    "dist": np.ones(4), "rvec": np.ones((v, 3)),
                    "tvec": np.ones((v, 3))}, v, dev)
    frozen = _ravel({"fx": 1.0, "fy": 1.0, "cx": 1.0, "cy": 1.0, "dist": np.zeros(4),
                     "rvec": np.ones((v, 3)), "tvec": np.ones((v, 3))}, v, dev)
    ar = None if fix_aspect_ratio is None else float(fix_aspect_ratio)

    def loss(flat):
        pred = _project(_unravel(flat, v), obj, model, aspect_ratio=ar)
        return torch.mean(torch.sum((pred - img) ** 2, dim=-1))

    # Staged: distortion frozen while poses and focal find the basin; a
    # free polynomial otherwise feeds back on wrong poses and diverges.
    p = _adam(loss, p, pixel * mask, frozen, steps)
    p = _lm_refine(p, obj, img, model, mask=mask, aspect_ratio=ar)
    with torch.no_grad():
        rms = float(torch.sqrt(loss(p)))
    params = {k: t.detach().cpu().numpy() for k, t in _unravel(p, v).items()}
    fx = params["fx"] if ar is None else np.float32(ar) * params["fy"]
    cam = Camera.make(fx, params["fy"], params["cx"], params["cy"], w, h, model,
                      dist=params["dist"])
    if full_output:
        extr = np.concatenate([params["rvec"], params["tvec"]], axis=1).astype(np.float64)
        return cam, rms, extr
    return cam, rms


def _adam(loss, p: torch.Tensor, scale: torch.Tensor, frozen: torch.Tensor,
          steps: int) -> torch.Tensor:
    """``steps`` Adam steps on the flat parameters ``p`` against ``loss``,
    optax's ``adam`` under ``exponential_decay(0.05, 1000, 0.5)``: its
    moments, bias corrections and step in float32 on ``p``'s device, the
    step count a device scalar. Each update is multiplied by ``scale``
    and, during the first ``steps // 2`` steps, by ``frozen``.

    On a card the step (forward, backward and update, about two hundred
    small kernels) is captured once as a CUDA graph
    (:func:`~video_annotator_tpu_torch.ops.cuda_lib.graphed`) and
    replayed: the loop is bound by launches otherwise."""
    p = p.detach().clone().requires_grad_(True)
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    t = torch.zeros((), dtype=torch.float32, device=p.device)
    half = float(steps // 2)

    def step():
        (g,) = torch.autograd.grad(loss(p), p)
        with torch.no_grad():
            t.add_(1.0)
            m.copy_((1 - ADAM_B1) * g + ADAM_B1 * m)
            v.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * v)
            m_hat = m / (1 - ADAM_B1 ** t)
            v_hat = v / (1 - ADAM_B2 ** t)
            lr = LR0 * 0.5 ** ((t - 1.0) / LR_HALF_LIFE)
            update = m_hat / (torch.sqrt(v_hat) + ADAM_EPS) * -lr * scale
            update = torch.where(t <= half, update * frozen, update)
            p.add_(update)

    if p.device.type != "cuda" or steps <= cuda_lib.GRAPH_WARMUP:
        for _ in range(steps):
            step()
        return p.detach()
    replay = cuda_lib.graphed(step)  # its warm-up calls are the first steps
    for _ in range(steps - cuda_lib.GRAPH_WARMUP):
        replay()
    return p.detach()


def _lm_refine(p: torch.Tensor, obj: torch.Tensor, img: torch.Tensor, model: CameraModel,
               iters: int = 40, mask: Optional[torch.Tensor] = None,
               aspect_ratio: Optional[float] = None) -> torch.Tensor:
    """Levenberg-Marquardt polish of the flat Adam solution ``p``.

    Adam finds the basin but crawls along calibration's ill-conditioned
    focal/distortion/depth trade-off; LM on the same residuals converges
    in a few dozen normal-equation solves (about 8 + 6V parameters). The
    residuals and their ``jacfwd`` Jacobian are float32 on ``p``'s device;
    the solve is float64 numpy."""
    views = img.shape[0]
    dev = p.device
    flat_mask = (mask.detach().cpu().numpy().astype(np.float64) if mask is not None
                 else np.ones(p.shape[0]))

    def resid(q):
        return (_project(_unravel(q, views), obj, model, aspect_ratio=aspect_ratio)
                - img).reshape(-1)

    jac = torch.func.jacfwd(resid)

    def at(x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x.astype(np.float32), device=dev)

    def resid_np(x: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return resid(at(x)).cpu().numpy().astype(np.float64)

    x = p.detach().cpu().numpy().astype(np.float64)
    r = resid_np(x)
    cost = float(r @ r)
    lam = 1e-3
    for _ in range(iters):
        J = jac(at(x)).detach().cpu().numpy().astype(np.float64)
        J *= flat_mask  # fixed params: zero column -> zero gradient and step
        jtj = J.T @ J
        g = J.T @ r
        scale = np.diag(np.maximum(np.diag(jtj), 1e-8))
        improved = False
        for _ in range(8):
            try:
                delta = np.linalg.solve(jtj + lam * scale, -g)
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            x_new = x + delta
            r_new = resid_np(x_new)
            c_new = float(r_new @ r_new)
            if c_new < cost:
                x, r, cost = x_new, r_new, c_new
                lam = max(lam * 0.3, 1e-10)
                improved = True
                break
            lam *= 10.0
        if not improved:
            break
    return at(x)


def board_object_points(cols: int, rows: int, square_size: float = 1.0,
                        pattern: PatternType = PatternType.CHESSBOARD):
    """(cols*rows, 3) board feature coordinates (z = 0). The asymmetric
    circles grid staggers odd rows by one square
    (``camera_calibration.cpp:527-540`` ``calcBoardCornerPositions``)."""
    xs, ys = np.meshgrid(np.arange(cols), np.arange(rows))
    if pattern == PatternType.ASYMMETRIC_CIRCLES_GRID:
        xs = 2 * xs + ys % 2
    return np.stack([xs.ravel(), ys.ravel(), np.zeros(cols * rows)],
                    axis=1).astype(np.float64) * float(square_size)


def detect_pattern(gray, pattern: Tuple[int, int],
                   pattern_type: PatternType = PatternType.CHESSBOARD):
    """Find one calibration target in a grayscale image, as the reference's
    detection switch (``camera_calibration.cpp:354-368``): chessboard
    corners (adaptive threshold + normalize, subpixel-refined) or
    ``findCirclesGrid``. Returns (N, 2) float32 points or ``None``."""
    import cv2

    cols, rows = pattern
    if pattern_type == PatternType.CHESSBOARD:
        flags = cv2.CALIB_CB_ADAPTIVE_THRESH | cv2.CALIB_CB_NORMALIZE_IMAGE
        found, pts = cv2.findChessboardCorners(gray, (cols, rows), flags)
        if not found:
            return None
        crit = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_COUNT, 30, 0.01)
        pts = cv2.cornerSubPix(gray, pts, (11, 11), (-1, -1), crit)
    else:
        flags = (cv2.CALIB_CB_ASYMMETRIC_GRID
                 if pattern_type == PatternType.ASYMMETRIC_CIRCLES_GRID
                 else cv2.CALIB_CB_SYMMETRIC_GRID)
        found, pts = cv2.findCirclesGrid(gray, (cols, rows), flags=flags)
        if not found:
            return None
    return pts.reshape(-1, 2).astype(np.float32)


# Live-capture bound: about 5 minutes at 30 fps (a headless CLI must not
# spin forever when no board ever appears).
_LIVE_CAPTURE_MAX_FRAMES = 9000


def _iter_gray_frames(source: str):
    """Yield ``(gray, (w, h), fps)`` from a video, an image list or a live
    camera, as the reference's input switch
    (``camera_calibration.cpp:96-121``): a ``.xml``/``.yaml``/``.yml``
    path is a FileStorage list of image files (fps ``None``); a numeric
    string opens that capture device (a clean ``ValueError`` where there
    is none); anything else decodes through the port's readers (luma)."""
    import cv2

    if source.split(".")[-1].lower() in ("xml", "yaml", "yml"):
        fs = cv2.FileStorage(source, cv2.FILE_STORAGE_READ)
        try:
            node = fs.getNode("images")
            if node.empty():
                node = fs.root().at(0) if fs.root().size() else node
            files = [node.at(i).string() for i in range(node.size())]
        finally:
            fs.release()
        base = os.path.dirname(os.path.abspath(source))
        for f in files:
            path = f if os.path.isabs(f) else os.path.join(base, f)
            img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
            if img is None:
                raise FileNotFoundError(f"image list entry not readable: {f}")
            yield img, (img.shape[1], img.shape[0]), None
        return
    if source.isdigit():
        cap = cv2.VideoCapture(int(source))
        if not cap.isOpened():
            cap.release()
            raise ValueError(
                f"live-camera calibration input: no capture device "
                f"/dev/video{source} is present/openable on this host; "
                "record a clip (or an image-list .xml) instead")
        try:
            fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
            for _ in range(_LIVE_CAPTURE_MAX_FRAMES):
                ok, frame = cap.read()
                if not ok:
                    return
                gray = frame if frame.ndim == 2 else cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
                yield gray, (gray.shape[1], gray.shape[0]), (float(fps) if fps > 0 else None)
        finally:
            cap.release()
        return  # an exhausted capture ends the input

    from video_annotator_tpu_torch.io.video import open_reader

    reader = open_reader(source)
    meta = reader.meta
    try:
        for y, _, _ in iter(reader):
            yield np.asarray(y), (meta.width, meta.height), float(meta.fps)
    finally:
        reader.close()


def _sampled_frames(source: str, interval_s: float, flip_vertical: bool):
    """The gray frames of :func:`_iter_gray_frames` at least ``interval_s``
    apart (every image of a list), flipped when asked, with ``(w, h)``."""
    import cv2

    stride = None
    for i, (gray, wh, fps) in enumerate(_iter_gray_frames(source)):
        if stride is None:
            stride = 1 if fps is None else max(1, int(round(interval_s * fps)))
        if i % stride:
            continue
        yield (cv2.flip(gray, 0) if flip_vertical else gray), wh


def detect_board_views(
    source: str,
    pattern: Tuple[int, int] = (9, 6),
    square_size: float = 1.0,
    max_views: int = 25,
    interval_s: float = 0.25,
    pattern_type: PatternType = PatternType.CHESSBOARD,
    flip_vertical: bool = False,
):
    """Detect calibration-target views across a video's frames, as the
    reference tool's capture loop (``camera_calibration.cpp:340-390``):
    optional flip, detection, views at least ``interval_s`` apart until
    ``max_views``. Returns ``(object_points (N, 3), image_points (V, N,
    2), (w, h))``."""
    cols, rows = pattern
    views = []
    size = None
    for gray, size in _sampled_frames(source, interval_s, flip_vertical):
        pts = detect_pattern(gray, (cols, rows), pattern_type)
        if pts is None:
            continue
        views.append(pts)
        if len(views) >= max_views:
            break
    if len(views) < 3:
        raise ValueError(
            f"found a {cols}x{rows} {pattern_type.value} in only "
            f"{len(views)} frames of {source}; calibration needs at least 3 views")
    obj = board_object_points(cols, rows, square_size, pattern_type)
    return obj, np.stack(views), size


@dataclasses.dataclass
class CalibrationSettings:
    """The reference calibrator's settings file, field for field
    (``Settings::read/write``, ``camera_calibration.cpp:25-75``; example
    ``in_VID5.xml``), read and written through cv2.FileStorage (XML, or
    YAML by extension). ``Show_UndistortedImage`` dumps PNGs here;
    ``Input_Delay`` spaces the sampled views."""

    board_width: int = 9
    board_height: int = 6
    square_size: float = 1.0
    pattern: PatternType = PatternType.CHESSBOARD
    input: str = ""
    flip_vertical: bool = False
    delay_ms: int = 100
    nr_frames: int = 25
    fix_aspect_ratio: float = 0.0  # 0 = free; >0 pins fx/fy to this ratio
    zero_tangent_dist: bool = True  # inert: the fisheye model has none
    fix_principal_point: bool = False
    output_file: str = "out_camera_data.xml"
    write_points: bool = False
    write_extrinsics: bool = False
    write_grid: bool = False
    show_undistorted: bool = False
    use_fisheye: bool = True
    fix_k: Tuple[bool, bool, bool, bool, bool] = (False, False, False, False, False)

    @staticmethod
    def read(path: str) -> "CalibrationSettings":
        import cv2

        fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
        if not fs.isOpened():
            raise FileNotFoundError(f"cannot open settings file {path}")
        try:
            node = fs.getNode("Settings")
            if node.empty():
                node = fs.root()

            def _i(name, default):
                n = node.getNode(name)
                return default if n.empty() else int(n.real())

            def _f(name, default):
                n = node.getNode(name)
                return default if n.empty() else float(n.real())

            def _s(name, default):
                n = node.getNode(name)
                # The reference's files quote strings inside the element.
                return default if n.empty() else n.string().strip('"')

            pat = _s("Calibrate_Pattern", "CHESSBOARD").upper()
            try:
                pattern = PatternType(pat)
            except ValueError:
                raise ValueError(f"Camera calibration mode does not exist: {pat}")
            return CalibrationSettings(
                board_width=_i("BoardSize_Width", 9),
                board_height=_i("BoardSize_Height", 6),
                square_size=_f("Square_Size", 1.0),
                pattern=pattern,
                input=_s("Input", ""),
                flip_vertical=bool(_i("Input_FlipAroundHorizontalAxis", 0)),
                delay_ms=_i("Input_Delay", 100),
                nr_frames=_i("Calibrate_NrOfFrameToUse", 25),
                fix_aspect_ratio=_f("Calibrate_FixAspectRatio", 0.0),
                zero_tangent_dist=bool(_i("Calibrate_AssumeZeroTangentialDistortion", 1)),
                fix_principal_point=bool(_i("Calibrate_FixPrincipalPointAtTheCenter", 0)),
                output_file=_s("Write_outputFileName", "out_camera_data.xml"),
                write_points=bool(_i("Write_DetectedFeaturePoints", 0)),
                write_extrinsics=bool(_i("Write_extrinsicParameters", 0)),
                write_grid=bool(_i("Write_gridPoints", 0)),
                show_undistorted=bool(_i("Show_UndistortedImage", 0)),
                use_fisheye=bool(_i("Calibrate_UseFisheyeModel", 1)),
                fix_k=tuple(bool(_i(f"Fix_K{i}", 0)) for i in range(1, 6)),
            )
        finally:
            fs.release()

    def write(self, path: str) -> None:
        import cv2

        fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
        try:
            fs.startWriteStruct("Settings", cv2.FileNode_MAP)
            fs.write("BoardSize_Width", self.board_width)
            fs.write("BoardSize_Height", self.board_height)
            fs.write("Square_Size", self.square_size)
            fs.write("Calibrate_Pattern", self.pattern.value)
            fs.write("Calibrate_NrOfFrameToUse", self.nr_frames)
            fs.write("Calibrate_FixAspectRatio", self.fix_aspect_ratio)
            fs.write("Calibrate_AssumeZeroTangentialDistortion", int(self.zero_tangent_dist))
            fs.write("Calibrate_FixPrincipalPointAtTheCenter", int(self.fix_principal_point))
            fs.write("Write_DetectedFeaturePoints", int(self.write_points))
            fs.write("Write_extrinsicParameters", int(self.write_extrinsics))
            fs.write("Write_gridPoints", int(self.write_grid))
            fs.write("Write_outputFileName", self.output_file)
            fs.write("Show_UndistortedImage", int(self.show_undistorted))
            fs.write("Calibrate_UseFisheyeModel", int(self.use_fisheye))
            fs.write("Input_FlipAroundHorizontalAxis", int(self.flip_vertical))
            fs.write("Input_Delay", self.delay_ms)
            fs.write("Input", self.input)
            for i, fk in enumerate(self.fix_k, start=1):
                fs.write(f"Fix_K{i}", int(fk))
            fs.endWriteStruct()
        finally:
            fs.release()


def write_camera_params(path: str, cam: Camera, rms: float,
                        settings: Optional[CalibrationSettings] = None,
                        image_points: Optional[np.ndarray] = None,
                        object_points: Optional[np.ndarray] = None,
                        n_views: int = 0,
                        extrinsics: Optional[np.ndarray] = None) -> None:
    """Write the fit as FileStorage XML/YAML with the reference's
    ``saveCameraParams`` field names (``camera_calibration.cpp:613-700``):
    camera_matrix, distortion_coefficients, image and board geometry, the
    RMS, and (per the settings' Write_* flags) the detected points, the
    board grid and the per-view extrinsics."""
    import cv2

    k = np.array([[float(cam.fx), 0.0, float(cam.cx)],
                  [0.0, float(cam.fy), float(cam.cy)],
                  [0.0, 0.0, 1.0]], np.float64)
    d = np.asarray(cam.dist, np.float64).ravel()
    if cam.model == CameraModel.RECTILINEAR:
        # The rectilinear fit holds (k1, k2, k3, unused); OpenCV's plumb-bob
        # vector is (k1, k2, p1, p2, k3).
        dist = np.asarray([d[0], d[1], 0.0, 0.0, d[2]], np.float64).reshape(-1, 1)
    else:
        dist = d[:4].reshape(-1, 1)  # fisheye: (k1..k4) theta-polynomial
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    try:
        fs.write("calibration_time", "")
        if n_views:
            fs.write("nr_of_frames", int(n_views))
        fs.write("image_width", int(cam.width))
        fs.write("image_height", int(cam.height))
        if settings is not None:
            fs.write("board_width", settings.board_width)
            fs.write("board_height", settings.board_height)
            fs.write("square_size", settings.square_size)
            if settings.fix_aspect_ratio > 0:
                fs.write("fix_aspect_ratio", settings.fix_aspect_ratio)
        fs.write("camera_matrix", k)
        fs.write("distortion_coefficients", dist)
        fs.write("avg_reprojection_error", float(rms))
        if settings is not None and settings.write_extrinsics and extrinsics is not None:
            fs.write("extrinsic_parameters", np.asarray(extrinsics, np.float64))
        if settings is not None and settings.write_grid and object_points is not None:
            # The ideal board grid: there is no object-point refinement.
            fs.write("grid_points", np.asarray(object_points, np.float64))
        if settings is not None and settings.write_points and image_points is not None:
            # (V, N, 2) float32 -> a V x N CV_32FC2 Mat.
            fs.write("image_points", np.ascontiguousarray(image_points, np.float32))
    finally:
        fs.release()


def run_from_settings(settings_path: str, output: Optional[str] = None,
                      show_undistorted_dir: Optional[str] = None,
                      device="cuda") -> Tuple[Camera, float]:
    """The reference tool's workflow from one settings file: read the
    settings, detect ``nr_frames`` views in ``Input``, calibrate with the
    configured model and flags, write the output FileStorage."""
    s = CalibrationSettings.read(settings_path)
    if not s.input:
        raise ValueError(f"settings file {settings_path} has no Input")
    here = os.path.dirname(os.path.abspath(settings_path))
    src = s.input
    if not os.path.isabs(src) and not os.path.exists(src):
        rel = os.path.join(here, src)
        if os.path.exists(rel):
            src = rel
    interval_s = max(s.delay_ms, 1) / 1000.0  # Input_Delay spaces the views
    obj, img, (w, h) = detect_board_views(
        src, (s.board_width, s.board_height), s.square_size, max_views=s.nr_frames,
        pattern_type=s.pattern, flip_vertical=s.flip_vertical, interval_s=interval_s)
    cam, rms, extr = calibrate(
        obj, img, (w, h), CameraModel.FISHEYE if s.use_fisheye else CameraModel.RECTILINEAR,
        # CALIB_FIX_ASPECT_RATIO applies to the non-fisheye model only: the
        # reference overwrites its flag word for fisheye (:138-146).
        fix_aspect_ratio=(s.fix_aspect_ratio
                          if s.fix_aspect_ratio > 0 and not s.use_fisheye else None),
        fix_principal_point=s.fix_principal_point, fix_k=s.fix_k[:4],
        full_output=True, device=device)
    out = output or s.output_file
    if not os.path.isabs(out):
        out = os.path.join(here, out)
    write_camera_params(out, cam, rms, settings=s, image_points=img, object_points=obj,
                        n_views=img.shape[0], extrinsics=extr)
    print(f"calibrated {img.shape[0]} views: rms {rms:.3f} px -> {out}")
    if show_undistorted_dir is None and s.show_undistorted:
        show_undistorted_dir = out + ".undistorted"
    if show_undistorted_dir:
        n = show_undistorted(cam, src, show_undistorted_dir, flip_vertical=s.flip_vertical,
                             interval_s=interval_s, device=device)
        print(f"wrote {n} undistorted view(s) to {show_undistorted_dir}")
    return cam, rms


def undistort(gray: np.ndarray, cam: Camera, device="cuda") -> np.ndarray:
    """One (H, W) uint8 frame undistorted through ``cam``: identity
    rotation into a rectilinear camera with the fitted K on the
    input-sized canvas (bounded for any fit, unlike OpenCV's balance=1
    camera); K1's float one-frame kernel on a card, the plain warp on the
    CPU. Truncated to uint8 after clipping, as the JAX package does."""
    from video_annotator_tpu_torch.ops import warp_kernel, warp_plain

    out_cam = Camera.make(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                          CameraModel.RECTILINEAR)
    dev = torch.device(device)
    src = torch.from_numpy(np.array(gray, np.float32)).to(dev)
    identity = so3.from_euler(0.0, 0.0, 0.0).to(dev)
    if dev.type == "cuda":
        und = warp_kernel.warp_frame_f32(src, identity, out_cam, cam,
                                         (out_cam.height, out_cam.width))
    else:
        und = warp_plain.warp_image(src, out_cam, cam, identity)
    return np.clip(und.cpu().numpy(), 0, 255).astype(np.uint8)


def show_undistorted(cam: Camera, source: str, directory: str, max_frames: int = 5,
                     interval_s: float = 1.0, flip_vertical: bool = False,
                     device="cuda") -> int:
    """The reference calibrator's post-fit view (``Show_UndistortedImage``,
    ``camera_calibration.cpp:707-720``), headless: sampled input frames
    undistorted through the fitted camera (:func:`undistort`) and written
    as ``undistorted_NNN.png``; also shown in a window where a GUI works.
    Returns the number of views written."""
    import cv2

    from video_annotator_tpu_torch.pipeline.render import gui_available

    os.makedirs(directory, exist_ok=True)
    gui = gui_available()
    n = 0
    for gray, _ in _sampled_frames(source, interval_s, flip_vertical):
        und = undistort(gray, cam, device)
        cv2.imwrite(os.path.join(directory, f"undistorted_{n:03d}.png"), und)
        if gui:
            try:
                cv2.imshow("undistorted", und)
                if cv2.waitKey(500) & 0xFF == 27:
                    gui = False
                    cv2.destroyWindow("undistorted")
            except cv2.error:
                gui = False
        n += 1
        if n >= max_frames:
            break
    if gui:
        try:
            cv2.destroyWindow("undistorted")
        except cv2.error:
            pass
    return n


def calibrate_cli(points_path: Optional[str], model: str, size: Optional[str],
                  output: Optional[str], board: str = "9x6", square_size: float = 1.0,
                  max_views: int = 25, interval_s: float = 0.25,
                  pattern: str = "chessboard", settings: Optional[str] = None,
                  flip_vertical: bool = False, show_undistorted_dir: Optional[str] = None,
                  device="cuda"):
    """The ``calibrate`` subcommand: a settings file's whole workflow, or
    a fit of detections from footage or a ``.npz``, printed as JSON and
    written to ``output`` (FileStorage by extension, else JSON)."""
    if settings:
        run_from_settings(settings, output, show_undistorted_dir=show_undistorted_dir,
                          device=device)
        return
    pat = {"chessboard": PatternType.CHESSBOARD, "circles": PatternType.CIRCLES_GRID,
           "acircles": PatternType.ASYMMETRIC_CIRCLES_GRID}[pattern]
    if points_path.endswith(".npz"):
        data = np.load(points_path)
        obj = data["object_points"]
        img = data["image_points"]
        detected = None
    else:
        cols, rows = (int(x) for x in board.lower().split("x"))
        obj, img, detected = detect_board_views(
            points_path, (cols, rows), square_size, max_views=max_views,
            interval_s=interval_s, pattern_type=pat, flip_vertical=flip_vertical)
        print(f"detected {img.shape[0]} board views in {points_path}")
        data = {}
    if obj.ndim == 3:
        obj = obj[0]  # cv2-style per-view board lists: one board
    if size:
        w, h = (int(x) for x in size.lower().split("x"))
    elif detected is not None:
        w, h = detected
    elif "image_size" in data:
        w, h = (int(x) for x in data["image_size"])
    else:
        w = int(np.ceil(img[..., 0].max())) + 1
        h = int(np.ceil(img[..., 1].max())) + 1
    cam, rms = calibrate(
        obj, img, (w, h),
        CameraModel.FISHEYE if model == "fisheye" else CameraModel.RECTILINEAR,
        device=device)
    if show_undistorted_dir:
        if detected is None:
            print("--show-undistorted needs footage input (a .npz has no "
                  "frames to undistort); skipped", file=sys.stderr)
        else:
            n_shown = show_undistorted(cam, points_path, show_undistorted_dir,
                                       flip_vertical=flip_vertical, interval_s=interval_s,
                                       device=device)
            print(f"wrote {n_shown} undistorted view(s) to {show_undistorted_dir}")
    result = {
        "model": cam.model.value,
        "fx": float(cam.fx), "fy": float(cam.fy),
        "cx": float(cam.cx), "cy": float(cam.cy),
        "dist": [float(d) for d in np.asarray(cam.dist)],
        "width": w, "height": h,
        "views": int(img.shape[0]),
        "rms_reprojection_error_px": rms,
    }
    text = json.dumps(result, indent=2)
    print(text)
    if output:
        if output.split(".")[-1].lower() in ("xml", "yml", "yaml"):
            write_camera_params(output, cam, rms, image_points=img, object_points=obj,
                                n_views=int(img.shape[0]))
        else:
            with open(output, "w") as f:
                f.write(text + "\n")
