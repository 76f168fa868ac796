"""The torch port's ``parallel/`` package over a gloo group of processes,
held against the JAX package's ``parallel/`` on the virtual 8-device CPU
mesh that ``tests/conftest.py`` sets up.

Two groups are spawned once for the module (``torch.multiprocessing``,
a ``FileStore`` in a temporary directory, a time limit of their own): four
ranks run every function on several meshes, one rank runs the same
functions unsharded. Each writes its gathered results to a file; the tests
compare them with JAX's and with each other:

- smoothing: atol 1e-5 against JAX and against the unsharded port
  (``sg_conv`` sums a window in an order that depends on the block's
  length: 3e-7 apart, 1.3e-6 after the projection onto SO(3));
- prefix product: atol 1e-4 against the sequential product; against the
  unsharded port atol 1e-6 (the blocks associate the product otherwise);
- stream and spatial warps: 0.05 overall against the JAX Pallas path in
  interpret mode (``tests/test_warp_pallas.py:39``), 0.02 on pixels whose
  taps lie inside the source (K1 evaluates ``atanf`` and the true 4-tap
  weights, the Pallas kernel its fitted polynomials: up to 0.011 on these
  noise frames); equal to the unsharded port;
- the pipeline step: against JAX's with JAX's RANSAC samples injected
  (the point pairs JAX's step draws from its keys and its own tracking
  status), and against the unsharded port, at the bar of
  ``__graft_entry__.dryrun_multichip``.
"""

import functools
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from test_torch_tracked import k2_branch  # noqa: F401 (fixture)
from test_torch_warp import to_port
from video_annotator_tpu.camera import CameraPreset, get_output_camera, get_preset_camera
from video_annotator_tpu.io.synthetic import SyntheticCamera as JSyntheticCamera
from video_annotator_tpu.parallel import mesh as jmesh
from video_annotator_tpu.smoothing.savgol import smooth_rotations as jsmooth_rotations
from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.camera import get_output_camera as tget_output_camera
from video_annotator_tpu_torch.io.synthetic import SyntheticCamera, render_frame
from video_annotator_tpu_torch.models.deshake import warp_frame_deshake
from video_annotator_tpu_torch.models.similarity import warp_frame_similarity
from video_annotator_tpu_torch.ops import warp_kernel, warp_plain
from video_annotator_tpu_torch.parallel import mesh as tmesh
from video_annotator_tpu_torch.parallel import pipeline as tpipeline
from video_annotator_tpu_torch.parallel import streams as tstreams
from video_annotator_tpu_torch.parallel import temporal as ttemporal

SPAWN_TIMEOUT_S = 240
SMOOTH_T, SMOOTH_RADIUS = 64, 8
STREAMS = 4  # one per rank of the data mesh
# The pipeline's clip: 512 columns, so that K2 tracks both pyramid levels
# (a staged level needs 256 columns) as JAX's XLA LK does.
CLIP = dict(w=512, h=384, streams=2, frames=8, radius=2)
INTERIOR_ATOL = 0.02
OVERALL_ATOL = 0.05  # tests/test_warp_pallas.py:39
SPATIAL_CASES = [("bilinear", "rect"), ("bicubic", "rect"), ("bilinear", "stereographic")]
STREAM_SIZES = [None, (40, 64), (41, 64)]  # 41 rows: the padded row grid
PIPELINE_MAX, PIPELINE_MEAN = 0.5, 0.01  # dryrun_multichip's bar, grey levels


# --- inputs: made from seeds with numpy, the same in every process --------


def random_rotations(t, scale, seed):
    w = np.random.default_rng(seed).normal(size=(t, 3)) * scale
    return so3.exp(torch.from_numpy(w.astype(np.float32))).numpy()


def stream_inputs():
    rng = np.random.default_rng(7)
    frames = np.round(rng.uniform(0, 255, (STREAMS, 96, 128))).astype(np.float32)
    return frames, random_rotations(STREAMS, 0.02, 8)


def yuv_inputs():
    rng = np.random.default_rng(11)
    ys = rng.uniform(0, 255, (STREAMS, 48, 64)).astype(np.float32)
    us = rng.uniform(0, 255, (STREAMS, 24, 32)).astype(np.float32)
    vs = rng.uniform(0, 255, (STREAMS, 24, 32)).astype(np.float32)
    sim = (rng.normal(size=(STREAMS, 4)) * [2.0, 2.0, 0.02, 0.02]).astype(np.float32)
    shift = (rng.normal(size=(STREAMS, 2)) * 4.0).astype(np.float32)
    return ys, us, vs, sim, shift


def spatial_frame():
    return np.round(np.random.default_rng(23).uniform(0, 255, (240, 320))).astype(np.float32)


def stream_cameras():
    jin = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (128, 96))
    return jin, get_output_camera(jin, scale=1.0, crop_borders=True)


def spatial_cameras(projection):
    from video_annotator_tpu.camera import CameraModel, camera_from_dfov

    jin = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (320, 240))
    jout = get_output_camera(jin, scale=1.0, crop_borders=True)
    if projection != "rect":
        jout = camera_from_dfov(120.0, (jout.width, jout.height), CameraModel(projection))
    return jin, jout


def clip():
    """(B, T, H, W) float32 luma of one shaken synthetic stream per b, and
    its input and auto-fit output cameras (port)."""
    cams = [SyntheticCamera(width=CLIP["w"], height=CLIP["h"], num_frames=CLIP["frames"],
                            shake=0.006, seed=17 * b + 1) for b in range(CLIP["streams"])]
    in_cam = cams[0].camera()
    frames = np.stack([
        np.stack([render_frame(in_cam, torch.from_numpy(r))[0].numpy()
                  for r in cam.rotations().astype(np.float32)])
        for cam in cams]).astype(np.float32)
    return frames, in_cam, tget_output_camera(in_cam, crop_borders=True)


# --- the spawned ranks --------------------------------------------------


def sharded_job(out, pairs_table):
    """Four ranks: every function of ``parallel/`` on the meshes it needs;
    rank 0 writes the gathered results."""
    rank = dist.get_rank()
    res = {}
    # time: smoothing and the prefix product, 16 frames per rank
    m = tmesh.make_mesh(axis_names=("time",), device_type="cpu")
    blk = SMOOTH_T // 4
    rots = torch.from_numpy(random_rotations(SMOOTH_T, 0.05, 0))[rank * blk:(rank + 1) * blk]
    res["smooth"] = tmesh.gather(
        ttemporal.smooth_rotations_sharded(rots, SMOOTH_RADIUS, m), m, "time")
    deltas = torch.from_numpy(random_rotations(SMOOTH_T, 0.05, 3))[rank * blk:(rank + 1) * blk]
    res["prefix"] = tmesh.gather(ttemporal.distributed_accumulate_rotations(deltas, m), m, "time")
    # data: one stream per rank, through row 6 and the 2D families
    m = tmesh.make_mesh(axis_names=("data",), device_type="cpu")
    frames, rots = stream_inputs()
    jin, jout = stream_cameras()
    for interp in ("bilinear", "bicubic"):
        local = tstreams.warp_streams_kernel_sharded(
            torch.from_numpy(frames[rank:rank + 1]), torch.from_numpy(rots[rank:rank + 1]),
            to_port(jout), to_port(jin), interp=interp)
        res[f"streams_{interp}"] = tmesh.gather(local, m, "data")
    ys, us, vs, sim, shift = (torch.from_numpy(a[rank:rank + 1]) for a in yuv_inputs())
    for name, warp, params in (("similarity", warp_frame_similarity, sim),
                               ("deshake", warp_frame_deshake, shift)):
        def batch(y, u, v, p, warp=warp):
            return tuple(torch.stack(planes) for planes in zip(*map(warp, y, u, v, p)))
        planes = batch(ys, us, vs, params)  # this rank's streams, no collectives
        res[name] = [tmesh.gather(p, m, "data") for p in planes]
    # space: one band of tile rows per rank, row 9
    m = tmesh.make_mesh(axis_names=("space",), device_type="cpu")
    frame = torch.from_numpy(spatial_frame())
    for interp, projection in SPATIAL_CASES:
        jin, jout = spatial_cameras(projection)
        res[f"spatial_{interp}_{projection}"] = tstreams.warp_frame_spatial(
            frame, torch.from_numpy(random_rotations(1, 0.03, 24)[0]), to_port(jout),
            to_port(jin), m, interp=interp)
    # data x space: the plain stream warp with its rows split
    m = tmesh.make_mesh(axis_names=("data", "space"), device_type="cpu")  # (2, 2)
    d = m.get_local_rank("data")
    jin, jout = stream_cameras()
    for size in STREAM_SIZES:
        local = tstreams.warp_streams_sharded(
            torch.from_numpy(frames[2 * d:2 * d + 2]), torch.from_numpy(rots[2 * d:2 * d + 2]),
            to_port(jout), to_port(jin), m, out_size=size)
        full = tmesh.gather(tmesh.gather(local, m, "space", dim=1), m, "data")
        res[f"xla_{size}"] = full[:, :(size or (jout.height,))[0]]
    # data x time: the pipeline step
    m = tmesh.make_mesh(device_type="cpu")  # (2, 2, 1)
    res.update(pipeline_results(m, pairs_table))
    if rank == 0:
        torch.save(res, out)


def pipeline_results(m, pairs_table):
    frames, in_cam, out_cam = clip()
    d, t = m.get_local_rank("data"), m.get_local_rank("time")
    bl = CLIP["streams"] // tmesh.axis_size(m, "data")
    tl = CLIP["frames"] // tmesh.axis_size(m, "time")
    local = torch.from_numpy(frames[d * bl:(d + 1) * bl, t * tl:(t + 1) * tl])
    table = torch.from_numpy(pairs_table)
    res = {}
    for name, pairs in (("pipeline", lambda status, b, gt: table[b, gt]),
                        ("pipeline_gen", None)):
        step = tpipeline.build_pipeline_step(m, in_cam, out_cam, smooth_radius=CLIP["radius"],
                                             hypothesis_pairs=pairs)
        out = step(local)
        res[name] = tmesh.gather(tmesh.gather(out, m, "time", dim=1), m, "data")
    return res


def single_job(out, pairs_table):
    """One rank: the same functions unsharded."""
    m = tmesh.make_mesh(axis_names=("time",), device_type="cpu")
    res = {"smooth": ttemporal.smooth_rotations_sharded(
        torch.from_numpy(random_rotations(SMOOTH_T, 0.05, 0)), SMOOTH_RADIUS, m),
        "prefix": ttemporal.distributed_accumulate_rotations(
            torch.from_numpy(random_rotations(SMOOTH_T, 0.05, 3)), m)}
    res.update(pipeline_results(tmesh.make_mesh(device_type="cpu"), pairs_table))
    torch.save(res, out)


def _rank(rank, world, store_path, job, out, pairs_table):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        job(out, pairs_table)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(world, job, tmp, pairs_table):
    """Start ``world`` ranks of ``job``; returns a join function that
    waits at most ``SPAWN_TIMEOUT_S`` and kills the ranks past it."""
    out = str(tmp / f"{job.__name__}.pt")
    ctx = mp.spawn(_rank, args=(world, str(tmp / f"{job.__name__}.store"), job, out,
                                pairs_table),
                   nprocs=world, join=False)

    def join():
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{job.__name__} ranks did not finish in "
                                       f"{SPAWN_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return torch.load(out)
    return join


def jax_pairs_table():
    """(B, T, H, 2) RANSAC samples: what JAX's pipeline step draws for pair
    (b, t), from the dryrun's per-frame key (``fold_in(fold_in(PRNGKey(0),
    b), t)``) and its own tracking status (``pyramidal_lk`` on the
    corners of the pair's first frame)."""
    from video_annotator_tpu.ops.corners import detect_corners
    from video_annotator_tpu.ops.lk import pyramidal_lk

    frames, _, _ = clip()
    key = jax.random.PRNGKey(0)
    table = []
    for b in range(CLIP["streams"]):
        seq = jnp.asarray(np.concatenate([frames[b, :1], frames[b]]))
        row = []
        for t in range(CLIP["frames"]):
            pts, valid = detect_corners(seq[t], max_corners=32, min_distance=8, border=4)
            _, status = pyramidal_lk(seq[t], seq[t + 1], pts, valid, levels=2, iters=5)
            row.append(jax_pairs(np.asarray(status),
                                 jax.random.fold_in(jax.random.fold_in(key, b), t), 16))
        table.append(row)
    return np.asarray(table, np.int64)


def jax_pairs(valid, key, num_hypotheses):
    """The sample pairs ``video_annotator_tpu/ops/ransac.py:97-108`` draws."""
    order = jnp.argsort(~jnp.asarray(valid), stable=True)
    v = jnp.maximum(jnp.sum(jnp.asarray(valid)), 2)

    def sample(k):
        k1, k2 = jax.random.split(k)
        i = jax.random.randint(k1, (), 0, v)
        j = jax.random.randint(k2, (), 0, v - 1)
        j = jnp.where(j >= i, j + 1, j)
        return jnp.stack([order[i], order[j]])

    return np.asarray(jax.vmap(sample)(jax.random.split(key, num_hypotheses)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    table = jax_pairs_table()
    joins = [spawn(4, sharded_job, tmp, table), spawn(1, single_job, tmp, table)]
    sharded, single = (join() for join in joins)
    return sharded, single, table


# --- the JAX side --------------------------------------------------------


def jax_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def interior(coords, h, w, pad):
    """Pixels whose taps all lie inside an (h, w) source: ``pad`` more
    pixels to each side than the bilinear footprint."""
    x, y = coords[..., 0], coords[..., 1]
    return (x >= pad) & (x <= w - 2 - pad) & (y >= pad) & (y <= h - 2 - pad)


def assert_warp_close(got, want, inside):
    np.testing.assert_allclose(got, want, atol=OVERALL_ATOL)
    np.testing.assert_allclose(got[inside], want[inside], atol=INTERIOR_ATOL)


# --- the tests -----------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_matches_jax(n):
    for k in (1, 2, 3):
        assert tmesh._factor(n, k) == jmesh._factor(n, k)


def test_initialize_multihost_without_a_cluster(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.initialize_multihost() is False
    assert not dist.is_initialized()


def test_sharded_smoothing_matches_jax(ranks):
    sharded, single, _ = ranks
    rots = random_rotations(SMOOTH_T, 0.05, 0)
    want = np.asarray(jsmooth_rotations(jnp.asarray(rots), SMOOTH_RADIUS))
    np.testing.assert_allclose(sharded["smooth"].numpy(), want, atol=1e-5)
    np.testing.assert_allclose(sharded["smooth"].numpy(), single["smooth"].numpy(), atol=1e-5)


def test_distributed_prefix_product_matches_sequential(ranks):
    sharded, single, _ = ranks
    deltas = random_rotations(SMOOTH_T, 0.05, 3)
    acc, want = np.eye(3, dtype=np.float32), []
    for d in deltas:
        acc = d @ acc
        want.append(acc.copy())
    np.testing.assert_allclose(sharded["prefix"].numpy(), np.stack(want), atol=1e-4)
    np.testing.assert_allclose(sharded["prefix"].numpy(), single["prefix"].numpy(), atol=1e-6)
    from video_annotator_tpu.parallel.temporal import distributed_accumulate_rotations

    jgot = distributed_accumulate_rotations(jnp.asarray(deltas), jax_mesh((4,), ("time",)))
    np.testing.assert_allclose(sharded["prefix"].numpy(), np.asarray(jgot), atol=1e-4)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_stream_kernel_warp_matches_jax_pallas(ranks, interp):
    from video_annotator_tpu.ops.warp_pallas import plan_warp
    from video_annotator_tpu.parallel.streams import warp_streams_pallas_sharded

    got = ranks[0][f"streams_{interp}"]
    frames, rots = stream_inputs()
    jin, jout = stream_cameras()
    plan = plan_warp(jout, jin, max_correction_deg=6.0, interp=interp)
    want = np.asarray(warp_streams_pallas_sharded(
        jnp.asarray(frames), jnp.asarray(rots), plan, jout, jin,
        jax_mesh((4,), ("data",)), interpret=True))
    coords = np.stack([warp_plain.compute_warp_map(to_port(jout), to_port(jin),
                                                   torch.from_numpy(r)).numpy() for r in rots])
    assert_warp_close(got.numpy(), want, interior(coords, 96, 128, 1))
    unsharded = warp_kernel.warp_frames_f32(torch.from_numpy(frames), torch.from_numpy(rots),
                                            to_port(jout), to_port(jin),
                                            (jout.height, jout.width), interp=interp)
    torch.testing.assert_close(got, unsharded, rtol=0, atol=0)


@pytest.mark.parametrize("family", ["similarity", "deshake"])
def test_yuv_streams_match_jax_and_the_unsharded_warp(ranks, family):
    from video_annotator_tpu.models.deshake import warp_frame_deshake as jdeshake
    from video_annotator_tpu.models.similarity import warp_frame_similarity as jsimilarity
    from video_annotator_tpu.parallel.streams import warp_yuv_streams_sharded

    got = ranks[0][family]
    ys, us, vs, sim, shift = yuv_inputs()
    params = sim if family == "similarity" else shift
    jwarp = (jsimilarity if family == "similarity"
             else lambda y, u, v, p: jdeshake(y, u, v, p, blur_edges=True))
    want = warp_yuv_streams_sharded(jax.vmap(jwarp), *map(jnp.asarray, (ys, us, vs, params)),
                                    jax_mesh((4,), ("data",)))
    twarp = warp_frame_similarity if family == "similarity" else warp_frame_deshake
    for i in range(STREAMS):
        single = twarp(*(torch.from_numpy(a[i]) for a in (ys, us, vs, params)))
        for g, w, s in zip(got, want, single):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w[i]), atol=0.02)
            torch.testing.assert_close(g[i], s, rtol=0, atol=0)


@pytest.mark.parametrize("interp,projection", SPATIAL_CASES)
def test_spatial_warp_matches_jax_pallas(ranks, interp, projection):
    from video_annotator_tpu.ops.warp_pallas import plan_warp
    from video_annotator_tpu.parallel.streams import warp_frame_pallas_spatial

    got = ranks[0][f"spatial_{interp}_{projection}"]
    jin, jout = spatial_cameras(projection)
    frame = spatial_frame()
    rot = random_rotations(1, 0.03, 24)[0]
    plan = plan_warp(jout, jin, max_correction_deg=6.0, interp=interp)
    want = np.asarray(warp_frame_pallas_spatial(
        jnp.asarray(frame), jnp.asarray(rot), plan, jout, jin, jax_mesh((4,), ("space",)),
        interpret=True))
    assert got.shape == want.shape == (jout.height, jout.width)
    coords = warp_plain.compute_warp_map(to_port(jout), to_port(jin),
                                         torch.from_numpy(rot)).numpy()
    assert_warp_close(got.numpy(), want, interior(coords, 240, 320, 1))
    whole = warp_kernel.warp_frame_f32(torch.from_numpy(frame), torch.from_numpy(rot),
                                       to_port(jout), to_port(jin), (jout.height, jout.width),
                                       interp=interp)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)


@pytest.mark.parametrize("size", STREAM_SIZES)
def test_plain_stream_warp_matches_jax(ranks, size):
    from video_annotator_tpu.parallel.streams import warp_streams_sharded

    got = ranks[0][f"xla_{size}"]
    frames, rots = stream_inputs()
    jin, jout = stream_cameras()
    want = np.asarray(warp_streams_sharded(jnp.asarray(frames), jnp.asarray(rots), jout, jin,
                                           jax_mesh((4, 2), ("data", "space")), out_size=size))
    assert got.shape == want.shape
    # JAX's own bar for this path (tests/test_parallel.py)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2)
    unsharded = tstreams.warp_streams_sharded(torch.from_numpy(frames), torch.from_numpy(rots),
                                              to_port(jout), to_port(jin), out_size=size)
    torch.testing.assert_close(got, unsharded, rtol=0, atol=0)


@pytest.mark.parametrize("branch", ["plain", "kernel"])
def test_track_pairs_matches_jax_lk(request, branch):
    """The step's tracking of one stream against JAX's corners and the
    JAX LK of the same branch, at the step's levels and iterations: on
    the CPU's branch the XLA ``pyramidal_lk`` (the same float LK, summed
    in another order), on the card's (``k2_branch``: K3's pair staging
    into K2's pairs form) the Pallas pairs LK in interpret mode, whose
    window rule clears the status of points near the bottom rows that
    the XLA LK keeps."""
    from video_annotator_tpu.ops.corners import detect_corners
    from video_annotator_tpu.ops.lk import pyramidal_lk
    from video_annotator_tpu.ops.lk_pallas import (
        lk_pack_pyramid_pairs,
        pyramidal_lk_pallas_pairs,
    )

    frames, in_cam, _ = clip()
    seq = frames[0]
    jpts, jvalid = jax.vmap(lambda f: detect_corners(f, max_corners=32, min_distance=8,
                                                     border=4))(jnp.asarray(seq[:-1]))
    if branch == "kernel":
        request.getfixturevalue("k2_branch")
        jnew, jstatus = pyramidal_lk_pallas_pairs(
            lk_pack_pyramid_pairs(jnp.asarray(seq), levels=2, interpret=True),
            seq.shape[-2:], jpts, jvalid, iters=5, interpret=True)
        flow_atol, min_status_agreement = 0.01, 0.99  # tests/test_torch_lk.py
    else:
        jnew, jstatus = jax.vmap(lambda a, b, q, v: pyramidal_lk(a, b, q, v, levels=2, iters=5))(
            jnp.asarray(seq[:-1]), jnp.asarray(seq[1:]), jpts, jvalid)
        flow_atol, min_status_agreement = 1e-3, 0.995
    pts, new_pts, status = tpipeline.track_pairs(torch.from_numpy(seq), in_cam, 32)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    got, want = status.numpy(), np.asarray(jstatus)
    assert (got == want).mean() >= min_status_agreement
    both = got & want
    assert both.sum() > 150
    np.testing.assert_allclose(new_pts.numpy()[both], np.asarray(jnew)[both], atol=flow_atol)


@functools.lru_cache(maxsize=1)
def jax_pipeline_output():
    from video_annotator_tpu.parallel.pipeline import build_pipeline_step

    frames, _, _ = clip()
    jin = JSyntheticCamera(width=CLIP["w"], height=CLIP["h"], num_frames=1,
                           shake=0.006).camera()
    jout = get_output_camera(jin, crop_borders=True)
    step = build_pipeline_step(jax_mesh((1, 1, 1), ("data", "time", "space")), jin, jout,
                               smooth_radius=CLIP["radius"])
    return np.asarray(step(jnp.asarray(frames), jax.random.PRNGKey(0)))


def test_pipeline_step_matches_jax_with_its_samples(ranks):
    got = ranks[0]["pipeline"].numpy()
    want = jax_pipeline_output()
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() < PIPELINE_MAX and diff.mean() < PIPELINE_MEAN, (diff.max(), diff.mean())


@pytest.mark.parametrize("name", ["pipeline", "pipeline_gen"])
def test_pipeline_step_does_not_depend_on_the_mesh(ranks, name):
    sharded, single, _ = ranks
    diff = (sharded[name] - single[name]).abs()
    assert diff.max() < PIPELINE_MAX and diff.mean() < PIPELINE_MEAN, (diff.max(), diff.mean())


def test_pipeline_corrections_are_not_identity(ranks):
    """The stabilised warp differs materially from an undistort under the
    identity (the dryrun's check)."""
    got = ranks[0]["pipeline_gen"]
    frames, in_cam, out_cam = clip()
    mid = CLIP["frames"] // 2
    ident = warp_kernel.warp_frame_f32(torch.from_numpy(frames[0, mid]), torch.eye(3),
                                       out_cam, in_cam, (out_cam.height, out_cam.width))
    assert float((got[0, mid] - ident).abs().mean()) > 0.5

