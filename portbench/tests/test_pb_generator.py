"""The benchmark's clip: the frozen copy renders what the port's synthetic
source renders, and its frames hold the rotations it claims."""

import numpy as np
import torch

from portbench import generator, harness, reference, trajfile

TINY = {"width": 192, "height": 144, "fps_num": 30000, "fps_den": 1001, "frames": 40,
        "preset": "gopro_h4b_wide43_measured",
        "assumed": {"motion": {"shake_rad": 0.004, "pan_rad_per_frame": 0.002}}}


def test_frames_match_the_ports_synthetic_renders(few_threads):
    from video_annotator_tpu_torch.camera import CameraPreset, get_preset_camera
    from video_annotator_tpu_torch.io.synthetic import render_frame

    clip = generator.Clip(TINY, seed=2**31 + 5)
    cam = get_preset_camera(CameraPreset(TINY["preset"]), (TINY["width"], TINY["height"]))
    assert (clip.camera.fx, clip.camera.fy, clip.camera.cx, clip.camera.cy) == (
        cam.fx, cam.fy, cam.cx, cam.cy)
    rots = clip.rotations()
    for t, y, u, v in clip.render("cpu", first=3, count=2):
        want = render_frame(cam, rots[t])
        for got, exp in zip((y, u, v), want):
            assert torch.equal(got, exp)


def test_seed_moves_the_trajectory_not_the_work():
    a = generator.Clip(TINY, 1).rotvecs
    b = generator.Clip(TINY, 2).rotvecs
    assert a.shape == b.shape and not np.allclose(a, b)
    assert np.array_equal(a, generator.Clip(TINY, 1).rotvecs)


def test_clip_holds_the_rotations_it_claims(tmp_path, few_threads):
    """The port's CPU analyse of the written clip follows the truth to a
    small fraction of a degree; a clip with other rotations does not."""
    from video_annotator_tpu_torch.pipeline.render import analyse

    clip = generator.Clip(TINY, 77)
    src = str(tmp_path / "clip.y4m")
    nbytes = clip.write_y4m(src, "cpu")
    assert nbytes == (tmp_path / "clip.y4m").stat().st_size
    opts = harness.render_options([src, "x.y4m", "--preset", TINY["preset"], "--stabilise",
                                   "smooth", "--device", "cpu"])
    traj = analyse(src, opts, device="cpu")
    expect = reference.expected_rotations(clip.rotvecs)
    err = reference.angle_errors_deg(traj.params, expect)
    assert len(err) == TINY["frames"] and float(np.sqrt(np.mean(err ** 2))) < 0.05
    other = reference.expected_rotations(generator.Clip(TINY, 78).rotvecs)
    assert float(np.sqrt(np.mean(reference.angle_errors_deg(traj.params, other) ** 2))) > 0.2


def test_truth_trajectory_file_round_trips(tmp_path):
    from video_annotator_tpu_torch.pipeline.trajectory import Trajectory

    clip = generator.Clip(TINY, 3)
    path = str(tmp_path / "t.traj.npz")
    params = reference.truth_params(clip.rotvecs)
    trajfile.write(path, params, clip.fps, clip.width, clip.height, "clip.y4m")
    traj = Trajectory.load(path)
    assert traj.kind == "so3" and traj.fps == clip.fps and traj.num_frames == clip.frames
    np.testing.assert_array_equal(traj.params, trajfile.read_params(path))
    err = reference.angle_errors_deg(params, reference.expected_rotations(clip.rotvecs))
    assert float(err.max()) < 1e-6
