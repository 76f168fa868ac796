"""The port's calibration host half against the JAX package's on the CPU:
board coordinates, detection from rendered footage and image lists, the
settings file, the FileStorage output, the undistorted views and the
``calibrate`` subcommand."""

import argparse
import json
from fractions import Fraction

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_calibrate import _render_board_frames, _render_circle_frames
from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from video_annotator_tpu import calibrate as jcal
from video_annotator_tpu import cli as jcli
from video_annotator_tpu import so3 as jso3
from video_annotator_tpu.camera import Camera as JCamera
from video_annotator_tpu.camera import CameraModel as JCameraModel
from video_annotator_tpu_torch import calibrate as tcal
from video_annotator_tpu_torch import cli as tcli
from video_annotator_tpu_torch.camera import Camera, CameraModel
from video_annotator_tpu_torch.io.synthetic import render_chessboard
from video_annotator_tpu_torch.io.video import VideoMeta, open_writer

INTRINSICS_RTOL = 1e-3
RMS_ATOL = 0.01  # px
TRUE = (300.0, 302.0, 321.0, 239.0)
DIST = (0.02, -0.005, 0.0, 0.0)
PATTERNS = {"chessboard": (tcal.PatternType.CHESSBOARD, jcal.PatternType.CHESSBOARD),
            "circles": (tcal.PatternType.CIRCLES_GRID, jcal.PatternType.CIRCLES_GRID),
            "acircles": (tcal.PatternType.ASYMMETRIC_CIRCLES_GRID,
                         jcal.PatternType.ASYMMETRIC_CIRCLES_GRID)}
REFERENCE_SETTINGS = """<?xml version="1.0"?>
<opencv_storage>
<Settings>
  <BoardSize_Width> 9</BoardSize_Width>
  <BoardSize_Height>6</BoardSize_Height>
  <Square_Size>50</Square_Size>
  <Calibrate_Pattern>"ASYMMETRIC_CIRCLES_GRID"</Calibrate_Pattern>
  <Input>"/tmp/clip.MP4"</Input>
  <Input_FlipAroundHorizontalAxis>1</Input_FlipAroundHorizontalAxis>
  <Input_Delay>100</Input_Delay>
  <Calibrate_NrOfFrameToUse>25</Calibrate_NrOfFrameToUse>
  <Calibrate_FixAspectRatio> 1 </Calibrate_FixAspectRatio>
  <Calibrate_AssumeZeroTangentialDistortion>1</Calibrate_AssumeZeroTangentialDistortion>
  <Calibrate_FixPrincipalPointAtTheCenter> 0 </Calibrate_FixPrincipalPointAtTheCenter>
  <Write_outputFileName>"out_camera_data.xml"</Write_outputFileName>
  <Write_DetectedFeaturePoints>1</Write_DetectedFeaturePoints>
  <Write_extrinsicParameters>1</Write_extrinsicParameters>
  <Write_gridPoints>1</Write_gridPoints>
  <Show_UndistortedImage>1</Show_UndistortedImage>
  <Calibrate_UseFisheyeModel>1</Calibrate_UseFisheyeModel>
  <Fix_K1>1</Fix_K1>
  <Fix_K2>0</Fix_K2>
  <Fix_K3>1</Fix_K3>
</Settings>
</opencv_storage>
"""


def cameras(model=CameraModel.FISHEYE, jmodel=JCameraModel.FISHEYE, dist=DIST):
    return (Camera.make(*TRUE, 640, 480, model, dist=dist),
            JCamera.make(*TRUE, 640, 480, jmodel, dist=jnp.asarray(dist, jnp.float32)))


def poses(n, seed, center=(4.0, 2.5), spread=(1.2, 1.0)):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        R = np.asarray(jso3.exp(jnp.asarray(
            rng.normal(size=3) * np.array([0.22, 0.22, 0.1]), jnp.float32)))
        t = np.array([-center[0] + rng.uniform(-spread[0], spread[0]),
                      -center[1] + rng.uniform(-spread[1], spread[1]),
                      rng.uniform(11.0, 16.0)])
        out.append((R, t))
    return out


def write_y4m(path, frames):
    h, w = frames[0].shape
    writer = open_writer(str(path), VideoMeta(w, h, Fraction(30, 1)))
    uv = np.full((h // 2, w // 2), 128, np.uint8)
    for y in frames:
        writer.write((y, uv, uv))
    writer.close()


def assert_fits_agree(got, want):
    (tcam, trms), (jcam, jrms) = got, want
    np.testing.assert_allclose([tcam.fx, tcam.fy, tcam.cx, tcam.cy],
                               [float(jcam.fx), float(jcam.fy), float(jcam.cx),
                                float(jcam.cy)], rtol=INTRINSICS_RTOL)
    assert abs(trms - jrms) <= RMS_ATOL, (trms, jrms)
    assert trms < 1.0
    for v, t, tol in zip((tcam.fx, tcam.fy, tcam.cx, tcam.cy), TRUE, (6.0, 6.0, 8.0, 8.0)):
        assert abs(v - t) < tol, (v, t)


def test_board_renderer_matches_the_jax_tests():
    """The port's chessboard renderer (for footage on a card, where JAX is
    absent) draws the JAX tests' frames byte for byte."""
    tcam, jcam = cameras()
    p = poses(3, 4)
    for got, want in zip(render_chessboard(tcam, p), _render_board_frames(jcam, p)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_board_object_points_match_jax(pattern):
    tp, jp = PATTERNS[pattern]
    np.testing.assert_array_equal(tcal.board_object_points(4, 11, 2.0, tp),
                                  jcal.board_object_points(4, 11, 2.0, jp))


def test_video_detection_and_fit_match_jax(tmp_path):
    """test_calibrate.py::test_calibrate_from_video_detection: footage in,
    the same detections and the same fit out."""
    tcam, _ = cameras()
    path = tmp_path / "board.y4m"
    write_y4m(path, render_chessboard(tcam, poses(8, 4)))
    tobj, timg, tsize = tcal.detect_board_views(str(path), max_views=8, interval_s=0.0)
    jobj, jimg, jsize = jcal.detect_board_views(str(path), max_views=8, interval_s=0.0)
    assert tsize == jsize == (640, 480) and timg.shape[0] >= 6
    np.testing.assert_array_equal(tobj, jobj)
    np.testing.assert_array_equal(timg, jimg)
    assert_fits_agree(tcal.calibrate(tobj, timg, tsize, CameraModel.FISHEYE, steps=1500,
                                     device="cpu"),
                      jcal.calibrate(jobj, jimg, jsize, JCameraModel.FISHEYE, steps=1500))


def test_settings_read_and_write_byte_for_byte(tmp_path):
    """The reference's settings schema read field for field as JAX reads
    it, and written back byte for byte as JAX writes it (XML and YAML)."""
    ref = tmp_path / "in.xml"
    ref.write_text(REFERENCE_SETTINGS)
    t = tcal.CalibrationSettings.read(str(ref))
    j = jcal.CalibrationSettings.read(str(ref))
    for field in ("board_width", "board_height", "square_size", "input", "flip_vertical",
                  "delay_ms", "nr_frames", "fix_aspect_ratio", "zero_tangent_dist",
                  "fix_principal_point", "output_file", "write_points", "write_extrinsics",
                  "write_grid", "show_undistorted", "use_fisheye", "fix_k"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.pattern.value == j.pattern.value == "ASYMMETRIC_CIRCLES_GRID"
    for name in ("rt.xml", "rt.yml"):
        t.write(str(tmp_path / f"t_{name}"))
        j.write(str(tmp_path / f"j_{name}"))
        assert (tmp_path / f"t_{name}").read_bytes() == (tmp_path / f"j_{name}").read_bytes()
        assert tcal.CalibrationSettings.read(str(tmp_path / f"t_{name}")) == t


def test_settings_refuse_an_unknown_pattern(tmp_path):
    bad = tmp_path / "bad.xml"
    bad.write_text(REFERENCE_SETTINGS.replace("ASYMMETRIC_CIRCLES_GRID", "DOTS"))
    with pytest.raises(ValueError, match="does not exist: DOTS"):
        tcal.CalibrationSettings.read(str(bad))


@pytest.mark.parametrize("model", ["fisheye", "rectilinear"])
def test_camera_params_file_is_written_as_jax_writes_it(tmp_path, model):
    """The same fit written by both packages: equal bytes, every Write_*
    field included (the rectilinear fit's k3 goes to OpenCV's fifth
    slot)."""
    tm, jm = ((CameraModel.FISHEYE, JCameraModel.FISHEYE) if model == "fisheye"
              else (CameraModel.RECTILINEAR, JCameraModel.RECTILINEAR))
    dist = (0.021, -0.004, 0.0013, 0.0)
    tcam, jcam = cameras(tm, jm, dist)
    s = tcal.CalibrationSettings(write_points=True, write_extrinsics=True, write_grid=True,
                                 fix_aspect_ratio=1.0)
    js = jcal.CalibrationSettings(write_points=True, write_extrinsics=True, write_grid=True,
                                  fix_aspect_ratio=1.0)
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 640, size=(3, 54, 2)).astype(np.float32)
    obj = tcal.board_object_points(9, 6)
    extr = rng.normal(size=(3, 6))
    tcal.write_camera_params(str(tmp_path / "t.xml"), tcam, 0.123, settings=s,
                             image_points=img, object_points=obj, n_views=3, extrinsics=extr)
    jcal.write_camera_params(str(tmp_path / "j.xml"), jcam, 0.123, settings=js,
                             image_points=img, object_points=obj, n_views=3, extrinsics=extr)
    assert (tmp_path / "t.xml").read_bytes() == (tmp_path / "j.xml").read_bytes()


def image_list(tmp_path, frames):
    names = []
    for i, f in enumerate(frames):
        names.append(f"view{i:02d}.png")
        cv2.imwrite(str(tmp_path / names[-1]), f)
    fs = cv2.FileStorage(str(tmp_path / "images.xml"), cv2.FILE_STORAGE_WRITE)
    fs.startWriteStruct("images", cv2.FileNode_SEQ)
    for n in names:
        fs.write("", n)
    fs.endWriteStruct()
    fs.release()


def read_storage(path):
    fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_READ)
    out = {}
    node = fs.root()
    for key in node.keys():
        n = node.getNode(key)
        out[key] = (n.string() if n.isString() else n.real() if n.isReal() or n.isInt()
                    else n.mat())
    fs.release()
    return out


def test_run_from_settings_writes_what_jax_writes(tmp_path):
    """test_calibrate.py::test_run_from_settings_image_list and
    ::test_run_from_settings_writes_extrinsics in one: an image list of
    a circles grid, every Write_* flag, Show_UndistortedImage. Both
    packages' files hold the same keys and shapes; their numbers agree
    within the fit's tolerances."""
    cols, rows = 7, 5
    tcam, jcam = cameras()
    obj = jcal.board_object_points(cols, rows, 1.0, jcal.PatternType.CIRCLES_GRID)
    center = obj.mean(0)
    frames = _render_circle_frames(jcam, poses(8, 9, center=center[:2], spread=(0.8, 0.8)),
                                   obj)
    image_list(tmp_path, frames)
    settings = f"""<?xml version="1.0"?>
<opencv_storage>
<Settings>
  <BoardSize_Width>{cols}</BoardSize_Width>
  <BoardSize_Height>{rows}</BoardSize_Height>
  <Square_Size>1</Square_Size>
  <Calibrate_Pattern>"CIRCLES_GRID"</Calibrate_Pattern>
  <Input>"images.xml"</Input>
  <Calibrate_NrOfFrameToUse>8</Calibrate_NrOfFrameToUse>
  <Calibrate_UseFisheyeModel>1</Calibrate_UseFisheyeModel>
  <Write_outputFileName>"OUT.xml"</Write_outputFileName>
  <Write_DetectedFeaturePoints>1</Write_DetectedFeaturePoints>
  <Write_extrinsicParameters>1</Write_extrinsicParameters>
  <Write_gridPoints>1</Write_gridPoints>
  <Show_UndistortedImage>1</Show_UndistortedImage>
</Settings>
</opencv_storage>
"""
    for who in ("t", "j"):
        (tmp_path / f"{who}.xml").write_text(settings.replace("OUT", f"{who}_out"))
    got = tcal.run_from_settings(str(tmp_path / "t.xml"), device="cpu")
    want = jcal.run_from_settings(str(tmp_path / "j.xml"))
    assert_fits_agree(got, want)
    t, j = read_storage(tmp_path / "t_out.xml"), read_storage(tmp_path / "j_out.xml")
    assert list(t) == list(j)
    for key in j:
        if isinstance(j[key], np.ndarray):
            assert t[key].shape == j[key].shape, key
    for key in ("image_points", "grid_points", "nr_of_frames", "image_width"):
        np.testing.assert_array_equal(t[key], j[key])
    np.testing.assert_allclose(t["camera_matrix"], j["camera_matrix"], rtol=INTRINSICS_RTOL)
    assert abs(t["avg_reprojection_error"] - j["avg_reprojection_error"]) <= RMS_ATOL
    assert t["avg_reprojection_error"] == got[1]
    assert np.all(t["extrinsic_parameters"][:, 5] > 5.0)
    np.testing.assert_allclose(t["extrinsic_parameters"], j["extrinsic_parameters"],
                               atol=0.01)
    views = sorted(p.name for p in (tmp_path / "t_out.xml.undistorted").iterdir())
    assert views == sorted(p.name for p in (tmp_path / "j_out.xml.undistorted").iterdir())
    assert views[0] == "undistorted_000.png"


def test_show_undistorted_matches_jax(tmp_path):
    """The same camera undistorts the same frames within one count of the
    JAX package's XLA warp (the plain warp on the CPU)."""
    tcam, jcam = cameras()
    src = "synthetic://shaky?w=640&h=480&n=3"
    assert tcal.show_undistorted(tcam, src, str(tmp_path / "t"), max_frames=2,
                                 interval_s=0.0, device="cpu") == 2
    assert jcal.show_undistorted(jcam, src, str(tmp_path / "j"), max_frames=2,
                                 interval_s=0.0) == 2
    for i in range(2):
        got = cv2.imread(str(tmp_path / "t" / f"undistorted_{i:03d}.png"), cv2.IMREAD_GRAYSCALE)
        want = cv2.imread(str(tmp_path / "j" / f"undistorted_{i:03d}.png"),
                          cv2.IMREAD_GRAYSCALE)
        d = np.abs(got.astype(np.int16) - want)
        assert got.shape == want.shape == (480, 640) and d.max() <= 1
        assert (d == 0).mean() >= 0.999


def _calibrate_actions(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {a.dest: a for a in sub.choices["calibrate"]._actions}


def test_cli_calibrate_arguments_match_jax():
    """JAX's eleven arguments, with their defaults and choices, plus
    ``--device``."""
    want = _calibrate_actions(jcli.build_parser())
    got = _calibrate_actions(tcli.build_parser())
    assert set(got) == set(want) | {"device"}
    for dest, w in want.items():
        for attr in ("option_strings", "default", "choices", "nargs", "type", "required"):
            assert getattr(got[dest], attr) == getattr(w, attr), (dest, attr)


def test_cli_calibrate_npz_matches_the_jax_cli(tmp_path, capsys, monkeypatch):
    """``calibrate points.npz -o params.json`` and ``-o params.xml``: the
    JSON and the FileStorage agree with the JAX CLI's."""
    from test_calibrate import _synthetic_views

    true = {"fx": jnp.float32(300.0), "fy": jnp.float32(302.0), "cx": jnp.float32(321.0),
            "cy": jnp.float32(238.0), "dist": jnp.asarray([0.03, -0.01, 0.0, 0.0], jnp.float32)}
    xs, ys = np.meshgrid(np.arange(9), np.arange(6))
    obj = np.stack([xs.ravel() - 4, ys.ravel() - 2.5, np.zeros(54)], axis=1)
    img = np.array(_synthetic_views(true, obj, n_views=8, model=JCameraModel.FISHEYE))
    npz = tmp_path / "points.npz"
    np.savez(npz, object_points=obj, image_points=img, image_size=np.array([640, 480]))
    assert tcli.main(["calibrate", str(npz), "--device", "cpu", "-o",
                      str(tmp_path / "t.json")]) == 0
    assert jcli.main(["calibrate", str(npz), "-o", str(tmp_path / "j.json")]) == 0
    t = json.loads((tmp_path / "t.json").read_text())
    j = json.loads((tmp_path / "j.json").read_text())
    assert set(t) == set(j) and (t["width"], t["height"], t["views"]) == (640, 480, 8)
    assert t["model"] == j["model"] == "fisheye"
    np.testing.assert_allclose([t[k] for k in ("fx", "fy", "cx", "cy")],
                               [j[k] for k in ("fx", "fy", "cx", "cy")], rtol=INTRINSICS_RTOL)
    assert abs(t["rms_reprojection_error_px"] - j["rms_reprojection_error_px"]) <= RMS_ATOL
    capsys.readouterr()
    fitted = tcal.calibrate(obj, img, (640, 480), steps=10, device="cpu")
    monkeypatch.setattr(tcal, "calibrate", lambda *args, **kwargs: fitted)  # the fit is above
    assert tcli.main(["calibrate", str(npz), "--device", "cpu", "--show-undistorted",
                      str(tmp_path / "v")]) == 0
    assert "a .npz has no frames to undistort" in capsys.readouterr().err


def test_cli_calibrate_needs_points_or_settings(capsys):
    assert tcli.main(["calibrate", "--device", "cpu"]) == 1
    assert "needs a points/video path or --settings" in capsys.readouterr().err


def test_live_camera_input_absent_device_errors_cleanly():
    with pytest.raises(ValueError, match="capture device"):
        next(tcal._iter_gray_frames("93"))


def test_live_camera_bounded_capture_ends_cleanly(monkeypatch):
    class FakeCap:
        def __init__(self, _id):
            pass

        def isOpened(self):
            return True

        def get(self, _prop):
            return 30.0

        def read(self):
            return True, np.full((24, 32, 3), 127, np.uint8)

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoCapture", FakeCap)
    monkeypatch.setattr(tcal, "_LIVE_CAPTURE_MAX_FRAMES", 4)
    frames = list(tcal._iter_gray_frames("0"))
    assert len(frames) == 4
    assert frames[0][0].shape == (24, 32) and frames[0][2] == 30.0


def test_undistort_refuses_nothing_on_the_cpu():
    """``undistort`` on the CPU is the plain warp; the truncation to uint8
    is the JAX package's (clip, then astype)."""
    tcam, _ = cameras()
    gray = np.full((480, 640), 200, np.uint8)
    out = tcal.undistort(gray, tcam, "cpu")
    assert out.dtype == np.uint8 and out.shape == (480, 640)
    assert out[240, 320] == 200 and torch.from_numpy(out).max() <= 200
