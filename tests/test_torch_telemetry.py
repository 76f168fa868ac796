"""The torch port's telemetry paths on the CPU, held against the JAX
package on the same numpy inputs: ``so3.slerp``, gyro integration (the
port's prefix product against the JAX scan), the gravity estimate and the
horizon lock, the GPMF and MP4 modules (byte for byte), ``analyse_gyro``
on a telemetry-only MP4, the corrections under ``--horizon-lock`` with
every smoother, the ``.traj.npz`` file with ``up0`` in both directions,
the ``--horizon-lock`` renders (two-phase, streaming, the compare grid's
``+lock`` and ``horizon`` cells), and which exceptions count as "this
source has no telemetry"."""

import importlib
import os
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_gpmf import write_minimal_gpmf_mp4
from test_torch_compare import OPTS as COMPARE_OPTS
from test_torch_compare import render_both
from test_torch_pipeline import PRESET, assert_u8_close, read_frames
from video_annotator_tpu import so3 as jso3
from video_annotator_tpu.camera import CameraPreset as JCameraPreset
from video_annotator_tpu.io import gpmf as jgpmf
from video_annotator_tpu.io import mp4 as jmp4
from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions
from video_annotator_tpu.pipeline.trajectory import Trajectory as JTrajectory
from video_annotator_tpu.smoothing import gyro as jgyro
from video_annotator_tpu.smoothing import horizon as jhorizon
from video_annotator_tpu_torch import so3 as tso3
from video_annotator_tpu_torch.camera import CameraPreset
from video_annotator_tpu_torch.io import gpmf as tgpmf
from video_annotator_tpu_torch.io import mp4 as tmp4
from video_annotator_tpu_torch.io.synthetic import (
    SyntheticCamera,
    telemetry_payloads,
    write_telemetry_mp4,
)
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline import streaming
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory, trajectory_path
from video_annotator_tpu_torch.smoothing import gyro as tgyro
from video_annotator_tpu_torch.smoothing import horizon as thorizon

# The module, not the function of the same name that the package exports.
jrender_mod = importlib.import_module("video_annotator_tpu.pipeline.render")

ATOL = 1e-5  # float32 geometry against the JAX functions on the CPU
UP_ATOL = 1e-4  # a weighted mean over hundreds of rotated samples
TILTED_UP = np.array([np.sin(0.12), -np.cos(0.12) * np.cos(0.05), np.sin(0.05)])


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rotations(n, seed, scale=0.3):
    w = (np.random.default_rng(seed).normal(size=(n, 3)) * scale).astype(np.float32)
    return np.array(jso3.exp(jnp.asarray(w)))


def gyro_stream(seconds, seed, hz=400.0, std=1.0):
    """(omega, ts) float32: noisy rates on a slightly irregular clock."""
    rng = np.random.default_rng(seed)
    n = int(seconds * hz)
    ts = (np.arange(n) / hz + rng.uniform(0, 2e-4, n)).astype(np.float32)
    return rng.normal(0, std, (n, 3)).astype(np.float32), ts


# --- so3.slerp, integrate_gyro ---------------------------------------------


def test_slerp_matches_jax():
    r0, r1 = rotations(40, 0), rotations(40, 1)
    t = np.random.default_rng(2).uniform(0, 1, 40).astype(np.float32)
    t[:2] = (0.0, 1.0)
    want = np.asarray(jso3.slerp(jnp.asarray(r0), jnp.asarray(r1), jnp.asarray(t)))
    got = tso3.slerp(torch.from_numpy(r0), torch.from_numpy(r1), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got[0].numpy(), r0[0], atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), r1[1], atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 33])
def test_prefix_products_match_a_sequential_loop(n):
    g = torch.Generator().manual_seed(n)
    steps = tso3.exp(torch.randn((n, 3), generator=g, dtype=torch.float64) * 0.2)
    want = [steps[0]]
    for s in steps[1:]:
        want.append(want[-1] @ s)
    got = tgyro.prefix_products(steps)
    np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(), atol=1e-12)


@pytest.mark.parametrize("seed,seconds", [(0, 2.0), (1, 2.0), (2, 1.0)])
def test_integrate_gyro_matches_jax_scan(seed, seconds):
    """The prefix product against the JAX package's ``lax.scan``: the same
    float32 steps multiplied in another order. Frame times before the
    first and after the last sample clamp as in the JAX function."""
    omega, ts = gyro_stream(seconds, seed)
    frame_ts = np.concatenate([[-0.1], np.arange(int(seconds * 30)) / 30.0 + 0.011,
                               [seconds + 1.0]]).astype(np.float32)
    want = np.asarray(jgyro.integrate_gyro(jnp.asarray(omega), jnp.asarray(ts),
                                           jnp.asarray(frame_ts)))
    got = tgyro.integrate_gyro(torch.from_numpy(omega), torch.from_numpy(ts),
                               torch.from_numpy(frame_ts)).numpy()
    assert got.shape == want.shape == (len(frame_ts), 3, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got[0], np.eye(3), atol=1e-6)


def test_integrate_gyro_constant_rate():
    """A camera spinning at a constant body rate w: the measured
    trajectory (the JAX package's test of the same name's convention) is
    exp(-w t)."""
    w = np.array([0.1, -0.2, 0.15], np.float32)
    ts = torch.linspace(0, 2.0, 800)
    frame_ts = torch.linspace(0, 2.0, 61)
    r = tgyro.integrate_gyro(torch.from_numpy(np.tile(w, (800, 1))), ts, frame_ts)
    measured = -tso3.log(r).numpy()
    np.testing.assert_allclose(measured, -np.outer(frame_ts.numpy(), w), atol=5e-3)


# --- horizon ----------------------------------------------------------------


def imu_streams(seed):
    omega, ts = gyro_stream(2.0, seed, std=0.5)
    rng = np.random.default_rng(seed + 100)
    accl_ts = (np.arange(400) / 200.0).astype(np.float32)
    accl = (TILTED_UP * 9.8 + rng.normal(0, 0.6, (400, 3))).astype(np.float32)
    accl[::37] *= 2.5  # impacts, which the weights discount
    return omega, ts, accl, accl_ts


@pytest.mark.parametrize("seed", [0, 1])
def test_estimate_up_direction_matches_jax(seed):
    omega, ts, accl, accl_ts = imu_streams(seed)
    want = jhorizon.estimate_up_direction(omega, ts, accl, accl_ts, t0=0.05)
    got = thorizon.estimate_up_direction(omega, ts, accl, accl_ts, t0=0.05,
                                         device="cpu")
    assert got.dtype == np.float64 and got.shape == (3,)
    np.testing.assert_allclose(got, want, atol=UP_ATOL)
    assert abs(np.linalg.norm(got) - 1.0) < 1e-5


def test_estimate_up_direction_degenerate_is_level():
    omega, ts, _, accl_ts = imu_streams(0)
    zero = np.zeros((len(accl_ts), 3), np.float32)
    want = jhorizon.estimate_up_direction(omega, ts, zero, accl_ts, t0=0.0)
    got = thorizon.estimate_up_direction(omega, ts, zero, accl_ts, t0=0.0, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0.0, -1.0, 0.0])


@pytest.mark.parametrize("up", [(0.0, -1.0, 0.0), tuple(TILTED_UP), (0.0, 0.0, 1.0)])
def test_level_horizon_matches_jax(up):
    virtual = rotations(30, 5)
    virtual[0] = np.eye(3)
    want = np.asarray(jhorizon.level_horizon(jnp.asarray(virtual),
                                             jnp.asarray(up, jnp.float32)))
    got = thorizon.level_horizon(torch.from_numpy(virtual),
                                 torch.tensor(up, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    if up[2] != 1.0:  # world-up lands on the image's up direction: no x part
        u = got @ np.asarray(up, np.float32)
        assert np.abs(u[:, 0]).max() < 1e-5 and (u[:, 1] < 0).all()


# --- GPMF and MP4, byte for byte ---------------------------------------------


def sensor_chunks(seed, n=4):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-3, 3, (20 + i, 3)), rng.uniform(-12, 12, (10 + i, 3)))
            for i in range(n)]


@pytest.mark.parametrize("with_accl", [False, True])
def test_gpmf_payload_bytes_and_parse_match_jax(with_accl):
    for gyro, accl in sensor_chunks(0):
        kw = dict(accl=accl) if with_accl else {}
        payload = tgpmf.build_gpmf_payload(gyro, **kw)
        assert payload == jgpmf.build_gpmf_payload(gyro, **kw)
        for fourcc in (b"GYRO", b"ACCL"):
            got = tgpmf.parse_sensor_packet(payload, 0.5, fourcc)
            want = jgpmf.parse_sensor_packet(payload, 0.5, fourcc)
            assert len(got) == len(want) == (1 if with_accl or fourcc == b"GYRO" else 0)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.samples, w.samples)
                assert g.timestamp == w.timestamp
        assert list(tgpmf.iter_klv(payload)) == list(jgpmf.iter_klv(payload))
    s = np.array([[1.0, 2.0, 3.0]])
    np.testing.assert_array_equal(tgpmf.gyro_to_camera(s), jgpmf.gyro_to_camera(s))
    assert tgpmf.parse_gyro_packet(payload, 0.0)[0].samples.shape == gyro.shape


def test_mp4_parse_and_extract_match_jax(tmp_path):
    path = str(tmp_path / "t.mp4")
    payloads = [tgpmf.build_gpmf_payload(g, accl=a) for g, a in sensor_chunks(1, 5)]
    write_minimal_gpmf_mp4(path, payloads)
    ttracks, jtracks = tmp4.parse_tracks(path), jmp4.parse_tracks(path)
    assert len(ttracks) == len(jtracks) == 1
    for f in ("handler_type", "handler_name", "timescale", "sample_sizes",
              "sample_offsets", "sample_times"):
        assert getattr(ttracks[0], f) == getattr(jtracks[0], f), f
    assert tmp4.find_gpmf_track(path).handler_name == jmp4.find_gpmf_track(path).handler_name
    tsamples = list(tmp4.read_track_samples(path, ttracks[0]))
    assert tsamples == list(jmp4.read_track_samples(path, jtracks[0]))
    assert [p for p, _ in tsamples] == payloads
    for textract, jextract in ((tgpmf.extract_gyro, jgpmf.extract_gyro),
                               (tgpmf.extract_accl, jgpmf.extract_accl)):
        for g, w in zip(textract(path), jextract(path)):
            np.testing.assert_array_equal(g, w)
    timu, jimu = tgpmf.extract_imu(path), jgpmf.extract_imu(path)
    for key in (b"GYRO", b"ACCL"):
        for g, w in zip(timu[key], jimu[key]):
            np.testing.assert_array_equal(g, w)


def test_mp4_mux_bytes_match_jax(tmp_path):
    """``build_gpmf_trak`` and ``mux_gpmf_track`` write the same bytes in
    both packages; the port's telemetry-only writer makes a file that
    both packages parse and that both can mux a second track into."""
    payloads = [tgpmf.build_gpmf_payload(g) for g, _ in sensor_chunks(2, 3)]
    offsets = [40, 400, 900]
    assert (tmp4.build_gpmf_trak(payloads, offsets, 1000, 1001, 3)
            == jmp4.build_gpmf_trak(payloads, offsets, 1000, 1001, 3))
    base = str(tmp_path / "base.mp4")
    tmp4.write_gpmf_mp4(base, payloads)
    for parse in (tmp4.parse_tracks, jmp4.parse_tracks):
        (track,) = parse(base)
        assert track.sample_sizes == [len(p) for p in payloads]
        assert track.sample_times[1] == pytest.approx(1.001)
    more = [tgpmf.build_gpmf_payload(g) for g, _ in sensor_chunks(3, 2)]
    tmp4.mux_gpmf_track(base, more, str(tmp_path / "t.mp4"), delta=500)
    jmp4.mux_gpmf_track(base, more, str(tmp_path / "j.mp4"), delta=500)
    with open(tmp_path / "t.mp4", "rb") as a, open(tmp_path / "j.mp4", "rb") as b:
        assert a.read() == b.read()
    assert len(tmp4.parse_tracks(str(tmp_path / "t.mp4"))) == 2
    omega, _ = tgpmf.extract_gyro(base)
    assert omega.shape == (sum(len(g) for g, _ in sensor_chunks(2, 3)), 3)
    with pytest.raises(ValueError, match="moov is not the last"):
        with open(tmp_path / "bad.mp4", "wb") as f, open(base, "rb") as src:
            f.write(src.read() + struct.pack(">I4s", 8, b"free"))
        tmp4.mux_gpmf_track(str(tmp_path / "bad.mp4"), more, str(tmp_path / "x.mp4"))


# --- analyse_gyro ------------------------------------------------------------


SYNTH = SyntheticCamera(width=128, height=96, num_frames=40, seed=3)


@pytest.mark.parametrize("kw", [dict(), dict(start=0.2, duration=0.5)])
def test_analyse_gyro_matches_jax(tmp_path, kw):
    path = str(tmp_path / "telemetry.mp4")
    write_telemetry_mp4(path, SYNTH, TILTED_UP)
    jtraj = jrender_mod.analyse_gyro(path, JRenderOptions(gyro=True, horizon_lock=True, **kw))
    ttraj = trender.analyse_gyro(path, trender.RenderOptions(
        gyro=True, horizon_lock=True, **kw), device="cpu")
    assert ttraj.num_frames == jtraj.num_frames == (15 if kw else 40)
    assert (ttraj.fps, ttraj.width, ttraj.height, ttraj.kind, ttraj.source) == \
        (jtraj.fps, jtraj.width, jtraj.height, jtraj.kind, jtraj.source)
    np.testing.assert_allclose(ttraj.params, jtraj.params, atol=1e-4)
    assert ttraj.up0 is not None and jtraj.up0 is not None
    np.testing.assert_allclose(ttraj.up0, jtraj.up0, atol=UP_ATOL)
    if not kw:  # with a trim, up is in the first KEPT frame's coordinates
        np.testing.assert_allclose(ttraj.up0, TILTED_UP, atol=2e-3)
    no_lock = trender.analyse_gyro(path, trender.RenderOptions(gyro=True), device="cpu")
    assert no_lock.up0 is None


def test_synthetic_telemetry_recovers_the_ground_truth(tmp_path):
    """The gyro stream written for a synthetic clip integrates back to the
    clip's ground-truth trajectory, well inside the 0.1 degree guard the
    visual analysers are held to."""
    path = str(tmp_path / "telemetry.mp4")
    write_telemetry_mp4(path, SYNTH)
    assert len(telemetry_payloads(SYNTH)) == 2  # 40 frames at 30 fps: 1.33 s
    traj = trender.analyse_gyro(path, trender.RenderOptions(gyro=True), device="cpu")
    r_true = torch.from_numpy(SYNTH.rotations())
    expect = tso3.matmul(tso3.transpose(r_true), r_true[0])
    err = tso3.log(tso3.matmul(torch.from_numpy(traj.rotations()), tso3.transpose(expect)))
    rms = np.degrees(float(torch.sqrt((err.norm(dim=-1) ** 2).mean())))
    assert traj.num_frames == 40 and rms < 0.01, rms


def test_render_gyro_analyse_only_through_render(tmp_path):
    """``render <telemetry mp4> -a --gyro --horizon-lock`` (with
    ``--streaming`` too: gyro takes the two-phase path) writes the
    trajectory and decodes nothing."""
    path = str(tmp_path / "telemetry.mp4")
    write_telemetry_mp4(path, SYNTH, TILTED_UP)
    dest = str(tmp_path / "out.y4m")
    prof = trender.StageProfiler()
    trender.render(path, dest, trender.RenderOptions(
        gyro=True, horizon_lock=True, analyse_only=True, streaming=True,
        stabilise="smooth"), profiler=prof, device="cpu")
    traj = Trajectory.load(trajectory_path(dest))
    assert traj.num_frames == 40 and traj.up0 is not None
    assert {"gyro-parse", "gyro-integrate"} <= set(prof.all_totals()[0])
    assert "decode" not in prof.all_totals()[0] and not os.path.exists(dest)


# --- corrections under the lock ------------------------------------------------


def measured_rotvecs(n=50, seed=4):
    rng = np.random.default_rng(seed)
    w = np.cumsum(rng.normal(0, 0.01, (n, 3)), 0)
    w[:, 2] += np.linspace(0.0, 0.15, n)  # slow roll drift, what the lock removes
    return w


@pytest.mark.parametrize("up0", [None, TILTED_UP])
@pytest.mark.parametrize("stabilise,smoother", [
    ("none", "savgol"), ("fixed", "savgol"), ("smooth", "savgol"), ("smooth", "kalman"),
])
def test_compute_corrections_horizon_lock_matches_jax(stabilise, smoother, up0):
    kw = dict(stabilise=stabilise, smoother=smoother, horizon_lock=True,
              stabilise_radius=12, roll=2.0, yaw=-1.0)
    params = measured_rotvecs()
    want = jrender_mod.compute_corrections(JTrajectory(params=params, up0=up0),
                                           JRenderOptions(**kw))
    got = trender.compute_corrections(Trajectory(params=params, up0=up0),
                                      trender.RenderOptions(**kw), device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape == (50, 3, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)
    unlocked = trender.compute_corrections(
        Trajectory(params=params, up0=up0),
        trender.RenderOptions(**dict(kw, horizon_lock=False)), device="cpu")
    if stabilise != "fixed" or up0 is not None:  # an identity camera is level already
        assert np.abs(got - unlocked).max() > 1e-3  # the lock does something


@pytest.mark.parametrize("up0", [None, TILTED_UP])
@pytest.mark.parametrize("stabilise,smoother,radius", [
    ("none", "savgol", 0), ("fixed", "savgol", 0), ("smooth", "savgol", 8),
    ("smooth", "kalman", 10),
])
def test_make_window_corrections_horizon_lock_matches_jax(stabilise, smoother, radius, up0):
    """Batch by batch on clamp-replicated windows, as streaming calls it;
    ``up0`` in the JAX position."""
    rots = np.asarray(jso3.exp(jnp.asarray(measured_rotvecs(), jnp.float32)))
    kw = dict(stabilise=stabilise, smoother=smoother, horizon_lock=True,
              stabilise_radius=radius)
    jfn = jrender_mod.make_window_corrections(radius, JRenderOptions(**kw), up0)
    tfn = trender.make_window_corrections(radius, trender.RenderOptions(**kw), up0)
    t_len, batch = rots.shape[0], 16
    for t0 in range(0, t_len, batch):
        idx = [min(max(k, 0), t_len - 1) for k in range(t0 - radius, t0 + batch + radius)]
        want = np.asarray(jfn(jnp.asarray(rots[idx])))
        got = tfn(torch.from_numpy(rots[idx])).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


# --- the trajectory file --------------------------------------------------------


def test_trajectory_with_up0_crosses_both_ways(tmp_path):
    """A file written by the JAX gyro analyser (``up0`` included) loads in
    the port and the reverse, field for field and dtype for dtype."""
    path = str(tmp_path / "telemetry.mp4")
    write_telemetry_mp4(path, SYNTH, TILTED_UP)
    jtraj = jrender_mod.analyse_gyro(path, JRenderOptions(gyro=True, horizon_lock=True))
    ttraj = trender.analyse_gyro(path, trender.RenderOptions(gyro=True, horizon_lock=True),
                                 device="cpu")
    jtraj.save(str(tmp_path / "j.traj.npz"))
    ttraj.save(str(tmp_path / "t.traj.npz"))
    from_jax = Trajectory.load(str(tmp_path / "j.traj.npz"))
    from_port = JTrajectory.load(str(tmp_path / "t.traj.npz"))
    np.testing.assert_array_equal(from_jax.params, jtraj.params)
    np.testing.assert_array_equal(from_jax.up0, jtraj.up0)
    np.testing.assert_array_equal(from_port.params, ttraj.params)
    np.testing.assert_array_equal(from_port.up0, ttraj.up0)
    assert (from_port.fps, from_port.kind, from_port.source) == (ttraj.fps, "so3", path)
    with np.load(str(tmp_path / "j.traj.npz")) as a, np.load(str(tmp_path / "t.traj.npz")) as b:
        assert set(a.files) == set(b.files) and "up0" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    opts = dict(stabilise="smooth", horizon_lock=True, stabilise_radius=10)
    np.testing.assert_allclose(
        trender.compute_corrections(from_jax, trender.RenderOptions(**opts), device="cpu"),
        jrender_mod.compute_corrections(from_port, JRenderOptions(**opts)), atol=1e-4)


# --- renders ---------------------------------------------------------------------


SRC = "synthetic://shaky?w=256&h=192&n=10&seed=5&shake=0.005"


@pytest.mark.parametrize("stabilise", ["none", "smooth"])
def test_horizon_lock_render_matches_jax(tmp_path, stabilise):
    """``render --horizon-lock``: the JAX package analyses (with
    ``--stabilise none`` too: the lock needs the attitude) and both
    packages encode from its trajectory file; a synthetic source has no
    telemetry, so up is taken as [0, -1, 0]."""
    jdest, tdest = str(tmp_path / "jax.y4m"), str(tmp_path / "torch.y4m")
    jopts = dict(stabilise=stabilise, horizon_lock=True, stabilise_radius=4,
                 preset=JCameraPreset(PRESET))
    jrender_mod.render(SRC, jdest, JRenderOptions(**jopts))
    jtraj = JTrajectory.load(jdest + ".traj.npz")
    assert jtraj.up0 is None and jtraj.num_frames == 10
    os.link(jdest + ".traj.npz", tdest + ".traj.npz")
    trender.render(SRC, tdest, trender.RenderOptions(
        stabilise=stabilise, horizon_lock=True, stabilise_radius=4, encode_only=True,
        preset=CameraPreset(PRESET)), device="cpu")
    (jmeta, jframes), (tmeta, tframes) = read_frames(jdest), read_frames(tdest)
    assert (tmeta.width, tmeta.height, len(tframes)) == (jmeta.width, jmeta.height, 10)
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert_u8_close(tp, jp)


def test_horizon_lock_render_analyses_without_stabilising(tmp_path):
    """``--horizon-lock`` alone runs the analyser in the port (two-phase
    and ``--streaming``), saves a trajectory, and the two renders agree."""
    two, one = str(tmp_path / "two.y4m"), str(tmp_path / "one.y4m")
    opts = dict(horizon_lock=True, preset=CameraPreset(PRESET), warp_batch=4)
    trender.render(SRC, two, trender.RenderOptions(**opts), device="cpu")
    trender.render(SRC, one, trender.RenderOptions(streaming=True, **opts), device="cpu")
    t_two, t_one = (Trajectory.load(trajectory_path(p)) for p in (two, one))
    assert t_two.num_frames == t_one.num_frames == 10 and t_two.up0 is None
    assert np.abs(t_two.params[1:]).max() > 1e-4  # a measured attitude, not identity
    np.testing.assert_allclose(t_one.params, t_two.params, atol=1e-6)
    (_, f_two), (_, f_one) = read_frames(two), read_frames(one)
    for a, b in zip(f_two, f_one):
        for pa, pb in zip(a, b):
            d = np.abs(pa.astype(np.int16) - pb.astype(np.int16))
            assert d.max() <= 1 and (d > 0).mean() <= 0.05
    plain = str(tmp_path / "plain.y4m")
    trender.render(SRC, plain, trender.RenderOptions(preset=CameraPreset(PRESET)),
                   device="cpu")
    assert not os.path.exists(trajectory_path(plain))


def test_streaming_horizon_lock_takes_up_from_telemetry(tmp_path, monkeypatch):
    """The streaming render asks for world-up once, passes it to the
    window corrections and saves it with the trajectory."""
    seen = []
    monkeypatch.setattr(streaming, "_estimate_up0",
                        lambda source, t0, device: seen.append((source, t0)) or TILTED_UP)
    dest = str(tmp_path / "one.y4m")
    streaming.render_streaming(SRC, dest, trender.RenderOptions(
        horizon_lock=True, stabilise="smooth", stabilise_radius=3, start=0.1,
        preset=CameraPreset(PRESET)), device="cpu")
    assert seen == [(SRC, 0.1)]
    traj = Trajectory.load(trajectory_path(dest))
    np.testing.assert_array_equal(traj.up0, TILTED_UP)
    two = str(tmp_path / "two.y4m")
    traj.save(trajectory_path(two))
    trender.render(SRC, two, trender.RenderOptions(
        horizon_lock=True, stabilise="smooth", stabilise_radius=3, start=0.1,
        encode_only=True, preset=CameraPreset(PRESET)), device="cpu")
    for a, b in zip(read_frames(two)[1], read_frames(dest)[1]):
        for pa, pb in zip(a, b):
            d = np.abs(pa.astype(np.int16) - pb.astype(np.int16))
            assert d.max() <= 1 and (d > 0).mean() <= 0.05


@pytest.mark.parametrize("modes", [
    ["none", "smooth+lock", "horizon"],
    ["horizon", "vidstab"],
    ["fixed+lock", "none+lock", "smooth", "deshake"],
])
def test_render_compare_lock_cells_match_jax(monkeypatch, tmp_path, modes):
    src = "synthetic://shaky?w=192&h=144&n=5&fps=30&seed=5&shake=0.005"
    (jmeta, jframes), (tmeta, tframes), seen = render_both(
        monkeypatch, tmp_path, src, modes, cell_labels=False)
    assert "rotation" in seen
    assert (tmeta.width, tmeta.height) == (jmeta.width, jmeta.height)
    assert len(tframes) == len(jframes) == 5
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert_u8_close(tp, jp)


def test_render_compare_horizon_analyses_with_the_lock(monkeypatch):
    """A grid whose only rotation cell is ``horizon`` still analyses, with
    the lock switched on for the analyser, and sizes its canvas with the
    stabilise buffer."""
    from video_annotator_tpu_torch.pipeline import compare as tcompare

    calls = []

    def fake_analyse(source, options, prof, device):
        calls.append(options.horizon_lock)
        return Trajectory(params=np.zeros((3, 3)), up0=TILTED_UP)

    monkeypatch.setattr(tcompare, "analyse", fake_analyse)
    cams = []
    build = tcompare.build_cameras
    monkeypatch.setattr(tcompare, "build_cameras",
                        lambda meta, o: cams.append(o.stabilise) or build(meta, o))
    tcompare.render_compare("synthetic://shaky?w=96&h=64&n=3", None, ["none", "horizon"],
                            trender.RenderOptions(cell_labels=False, **COMPARE_OPTS),
                            device="cpu")
    assert calls == [True] and cams == ["smooth"]


# --- what counts as "no telemetry" ------------------------------------------------


def test_estimate_up0_without_telemetry_is_none(tmp_path):
    y4m = str(tmp_path / "clip.y4m")
    trender.render("synthetic://shaky?w=64&h=48&n=2", y4m, trender.RenderOptions(),
                   device="cpu")
    gyro_only = str(tmp_path / "gyro.mp4")
    tmp4.write_gpmf_mp4(gyro_only, [tgpmf.build_gpmf_payload(g) for g, _ in sensor_chunks(4)])
    truncated = str(tmp_path / "cut.mp4")
    with open(gyro_only, "rb") as src, open(truncated, "wb") as dst:
        dst.write(src.read()[:-40])
    for source in ("synthetic://shaky?w=64&h=48&n=2", str(tmp_path / "missing.mp4"),
                   y4m, gyro_only, truncated):
        assert trender._estimate_up0(source, 0.0, "cpu") is None, source


def test_estimate_up0_lets_other_errors_through(tmp_path, monkeypatch):
    """Only what the parsers raise means "no telemetry": an error from the
    estimate itself (a device or kernel failure) must not become "assume
    level". The JAX package swallows every exception here."""
    path = str(tmp_path / "telemetry.mp4")
    write_telemetry_mp4(path, SYNTH, TILTED_UP)

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(trender, "estimate_up_direction", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        trender._estimate_up0(path, 0.0, "cpu")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        trender.analyse_gyro(path, trender.RenderOptions(gyro=True, horizon_lock=True),
                             device="cpu")
    monkeypatch.setattr(jhorizon, "estimate_up_direction", broken)
    assert jrender_mod._estimate_up0(path, 0.0) is None


def test_analyse_gyro_without_a_gyro_stream_raises(tmp_path):
    with pytest.raises(ValueError, match="no GoPro MET track"):
        y4m = str(tmp_path / "clip.y4m")
        trender.render("synthetic://shaky?w=64&h=48&n=2", y4m, trender.RenderOptions(),
                       device="cpu")
        trender.render(y4m, str(tmp_path / "o.y4m"),
                       trender.RenderOptions(gyro=True, stabilise="smooth"), device="cpu")
    with pytest.raises(ValueError, match="trim window"):
        path = str(tmp_path / "telemetry.mp4")
        write_telemetry_mp4(path, SYNTH)
        trender.analyse_gyro(path, trender.RenderOptions(gyro=True, start=50.0),
                             device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(filter="vidstab", horizon_lock=True), "horizon-lock needs the rotation family"),
    (dict(filter="deshake", rolling_shutter=0.7), "rolling-shutter needs the rotation"),
    (dict(rolling_shutter=0.7, streaming=True), "two-phase"),
    (dict(filter="vidstab", rolling_shutter=0.7, streaming=True), "rotation family"),
    (dict(rolling_shutter=0.7, streaming=True, gyro=True), "two-phase"),
])
def test_telemetry_refusals_match_jax(tmp_path, kw, match):
    src = "synthetic://shaky?w=64&h=48&n=4"
    with pytest.raises(ValueError, match=match):
        jrender_mod.render(src, str(tmp_path / "j.y4m"),
                           JRenderOptions(stabilise="smooth", **kw))
    with pytest.raises(ValueError, match=match):
        trender.render(src, str(tmp_path / "t.y4m"),
                       trender.RenderOptions(stabilise="smooth", **kw), device="cpu")
    assert not os.listdir(tmp_path)


def test_the_three_options_are_ported():
    """The render refuses no option any more (its table of unported ones
    is gone); the three telemetry options pass the family checks as the
    rotation family's."""
    assert not hasattr(trender, "check_ported")
    for kw in (dict(gyro=True), dict(horizon_lock=True), dict(rolling_shutter=0.75)):
        assert trender.check_family(trender.RenderOptions(**kw)) == "rotation"
