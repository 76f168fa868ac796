"""LK staging (plain version of kernel K3) and pyramidal LK (plain version
of kernel K2, pairs and per-frame forms) against the JAX package's pack
and its Pallas LK kernels run in interpret mode."""

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_annotator_tpu.ops.corners import detect_corners as jdetect_corners
from video_annotator_tpu.ops.lk_pallas import (
    lk_pack_pyramid,
    lk_pack_pyramid_pairs,
    pyramidal_lk_pallas_packed,
    pyramidal_lk_pallas_pairs,
)
from video_annotator_tpu.ops.warp_pallas import pack_frame_words
from video_annotator_tpu_torch.ops import lk_kernel, stage

MIN_STATUS_AGREEMENT = 0.99
FLOW_ATOL = 0.01  # px, where both sides track


def unpack_words(words: np.ndarray) -> np.ndarray:
    """(strips, word_rows, 128) quad-row int32 words -> (rows, cols) bytes."""
    words = np.asarray(words).astype(np.uint32)
    s, r, l = words.shape
    planes = np.stack([(words >> (8 * k)) & 0xFF for k in range(4)], axis=2)
    return planes.transpose(1, 2, 0, 3).reshape(4 * r, s * l).astype(np.uint8)


@pytest.mark.parametrize("pad_value", [0, 128])
@pytest.mark.parametrize("kind", ["float_ties", "uint8"])
def test_stage_matches_pack_frame_words(kind, pad_value):
    rng = np.random.default_rng(0)
    h, w = 45, 200  # pads in both directions
    if kind == "uint8":
        frames = rng.integers(0, 256, size=(3, h, w)).astype(np.uint8)
    else:
        # Half-integers (ties round to even), out-of-range values, fractions.
        frames = (rng.integers(-20, 560, size=(3, h, w)) * 0.5).astype(np.float32)
        frames[0, 0, :8] = [0.5, 1.5, 2.5, 253.5, 254.5, 255.5, -0.5, 127.49]
    got = stage.stage_u8(torch.from_numpy(frames), pad_value=pad_value).numpy()
    for t in range(3):
        want = unpack_words(pack_frame_words(jnp.asarray(frames[t]), h, w,
                                             pad_value=pad_value, use_kernel=False))
        np.testing.assert_array_equal(got[t], want)


def test_stage_slack_repeats_last_row_group():
    frames = torch.arange(3 * 40 * 130, dtype=torch.float32).reshape(3, 40, 130) % 251
    got = stage.stage_u8(frames, slack=32)
    assert got.shape == (3, 64 + 32, 256)
    for j in range(32):
        assert torch.equal(got[:, 64 + j], got[:, 60 + j % 4])


def texture(seed, w=640, h=480):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(h // 8, w // 8)).astype(np.float32)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)
    img = cv2.GaussianBlur(img, (0, 0), 1.0)
    return ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.float32)


def shifted_chunk():
    """Four frames, each shifted by a known sub-pixel offset from the last."""
    base = texture(1)
    shifts = [(0.0, 0.0), (3.25, -1.5), (5.5, 2.75), (4.0, 7.5)]
    frames = []
    for dx, dy in shifts:
        m = np.float32([[1, 0, dx], [0, 1, dy]])
        frames.append(cv2.warpAffine(base, m, (640, 480), flags=cv2.INTER_LINEAR,
                                     borderMode=cv2.BORDER_REFLECT))
    return np.stack(frames).astype(np.float32)


def test_stage_pyramid_matches_lk_pack_pyramid_pairs():
    frames = np.round(shifted_chunk())
    staged = lk_kernel.stage_pyramid_pairs(torch.from_numpy(frames))
    packed = lk_pack_pyramid_pairs(jnp.asarray(frames), interpret=True)
    assert len(staged) == len(packed)
    for got, words in zip(staged, packed):
        assert (got is None) == (words is None)
        if got is None:
            continue
        want = unpack_words(words).reshape(got.shape[0], -1, got.shape[2])
        np.testing.assert_array_equal(got.numpy(), want)


def test_lk_pairs_matches_pallas_interpret():
    frames = shifted_chunk()
    h, w = frames.shape[1:]
    pts0, valid0 = jdetect_corners(jnp.asarray(frames[0]), max_corners=40,
                                   min_distance=40)
    edge = np.array([[320.0, 9.0], [320.0, 14.0], [320.0, 30.0], [5.0, 240.0],
                     [20.0, 240.0], [630.0, 240.0], [600.0, 470.0], [320.0, 474.0]],
                    np.float32)
    pts = np.concatenate([np.asarray(pts0), edge])
    valid = np.concatenate([np.asarray(valid0), np.ones(len(edge), bool)])
    points = np.stack([pts] * 3)
    valids = np.stack([valid] * 3)

    want_pts, want_st = pyramidal_lk_pallas_pairs(
        lk_pack_pyramid_pairs(jnp.asarray(frames), interpret=True), (h, w),
        jnp.asarray(points), jnp.asarray(valids), iters=8, interpret=True)
    got_pts, got_st = lk_kernel.pyramidal_lk_pairs(
        lk_kernel.stage_pyramid_pairs(torch.from_numpy(frames)), (h, w),
        torch.from_numpy(points), torch.from_numpy(valids), iters=8)
    want_pts, want_st = np.asarray(want_pts), np.asarray(want_st)
    got_pts, got_st = got_pts.numpy(), got_st.numpy()
    assert (got_st == want_st).mean() >= MIN_STATUS_AGREEMENT
    both = got_st & want_st
    assert both.sum() > 60
    np.testing.assert_allclose(got_pts[both], want_pts[both], atol=FLOW_ATOL)
    # The tracks are right, not only alike: the known shift is recovered.
    truth = [(3.25, -1.5), (2.25, 4.25), (-1.5, 4.75)]
    for p, (dx, dy) in enumerate(truth):
        flow = got_pts[p][got_st[p]] - points[p][got_st[p]]
        np.testing.assert_allclose(np.median(flow, axis=0), [dx, dy], atol=0.1)


def test_stage_pyramid_matches_lk_pack_pyramid():
    frame = np.round(shifted_chunk()[1])
    staged = lk_kernel.stage_pyramid(torch.from_numpy(frame))
    packed = lk_pack_pyramid(jnp.asarray(frame), interpret=True)
    assert len(staged) == len(packed)
    for got, words in zip(staged, packed):
        assert (got is None) == (words is None)
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), unpack_words(words))


def frame_points(frame):
    """Corners plus edge points: the top and bottom rows, the left and
    right borders, the last 128-column strip and the last 8-word band."""
    pts0, valid0 = jdetect_corners(jnp.asarray(frame), max_corners=40,
                                   min_distance=40)
    edge = np.array([[320.0, 9.0], [320.0, 14.0], [320.0, 30.0], [5.0, 240.0],
                     [20.0, 240.0], [630.0, 240.0], [600.0, 470.0], [320.0, 474.0],
                     [600.0, 300.0], [610.0, 100.0], [560.0, 440.0], [320.0, 455.0]],
                    np.float32)
    pts = np.concatenate([np.asarray(pts0), edge])
    return pts, np.concatenate([np.asarray(valid0), np.ones(len(edge), bool)])


@pytest.mark.parametrize("pair", [(0, 1), (2, 3)])
def test_lk_per_frame_matches_pallas_interpret(pair):
    frames = shifted_chunk()
    h, w = frames.shape[1:]
    a, b = pair
    pts, valid = frame_points(frames[a])
    want_pts, want_st = pyramidal_lk_pallas_packed(
        lk_pack_pyramid(jnp.asarray(frames[a]), interpret=True),
        lk_pack_pyramid(jnp.asarray(frames[b]), interpret=True), (h, w),
        jnp.asarray(pts), jnp.asarray(valid), iters=8, interpret=True)
    got_pts, got_st = lk_kernel.pyramidal_lk_packed(
        lk_kernel.stage_pyramid(torch.from_numpy(frames[a])),
        lk_kernel.stage_pyramid(torch.from_numpy(frames[b])), (h, w),
        torch.from_numpy(pts), torch.from_numpy(valid), iters=8)
    want_pts, want_st = np.asarray(want_pts), np.asarray(want_st)
    got_pts, got_st = got_pts.numpy(), got_st.numpy()
    assert (got_st == want_st).mean() >= MIN_STATUS_AGREEMENT
    both = got_st & want_st
    assert both.sum() > 25
    np.testing.assert_allclose(got_pts[both], want_pts[both], atol=FLOW_ATOL)
    # Points of the last strip and the last band that fit their windows track.
    assert got_st[-4:].all() and want_st[-4:].all()
    truth = {(0, 1): (3.25, -1.5), (2, 3): (-1.5, 4.75)}[pair]
    flow = got_pts[got_st] - pts[got_st]
    np.testing.assert_allclose(np.median(flow, axis=0), truth, atol=0.1)


def test_lk_per_frame_matches_pairs_form():
    """Both forms read the same staged bytes through the same window
    rules, so they agree exactly on every pair."""
    frames = torch.from_numpy(shifted_chunk())
    h, w = frames.shape[1:]
    pts, valid = frame_points(frames[0].numpy())
    points = torch.from_numpy(np.stack([pts] * 3))
    valids = torch.from_numpy(np.stack([valid] * 3))
    pair_pts, pair_st = lk_kernel.pyramidal_lk_pairs(
        lk_kernel.stage_pyramid_pairs(frames), (h, w), points, valids, iters=8)
    staged = [lk_kernel.stage_pyramid(f) for f in frames]
    for p in range(3):
        got_pts, got_st = lk_kernel.pyramidal_lk_packed(
            staged[p], staged[p + 1], (h, w), points[p], valids[p], iters=8)
        assert torch.equal(got_st, pair_st[p])
        assert torch.equal(got_pts, pair_pts[p])


def test_lk_level_frame_refuses_mismatched_levels():
    a = torch.zeros((128, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="differ"):
        lk_kernel.lk_level_frame(a, torch.zeros((160, 256), dtype=torch.uint8),
                                 torch.zeros((1, 6)), torch.zeros((1, 4), dtype=torch.int32))


def test_lk_level_frame_refuses_other_devices():
    """CPU tensors take the plain version; any other non-CUDA device
    raises instead of silently falling back."""
    meta = torch.device("meta")
    level = torch.empty((128, 256), dtype=torch.uint8, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        lk_kernel.lk_level_frame(level, level, torch.empty((4, 6), device=meta),
                                 torch.empty((4, 4), dtype=torch.int32, device=meta))
