"""The rules K1's grouped kernels rest on, held on the plain side in float32.

``csrc/warp.cu`` and ``csrc/warp_modes.cu`` read the taps of an interior
pixel without predicates. They tell an interior pixel from its float
coordinate ``s`` alone: ``s >= 0 and s < w - 1`` for the 2x2 taps at
floor(s) and floor(s) + 1, ``s >= 1 and s < w - 2`` for the 4x4 taps at
floor(s) - 1 .. floor(s) + 2. These tests hold each test equal to the
integer tests on floor(s) that the edge path makes, for any float32 ``s``
and any width.

The bicubic mode evaluates, for the fraction f of floor's coordinate,
only the branch of Keys's kernel that each offset can take: f + 1 and
2 - f lie in [1, 2] (the far branch inside, 0 at either end), f and 1 - f
in [0, 1] (the near branch). ``branch_keys`` below is that rule as the
kernel evaluates it, one float32 rounding per operation; the tests hold
it to ``warp_plain.keys_weight`` bit for bit (signs of zero included) for
every float32 f in [0, 1].
"""

import numpy as np
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from video_annotator_tpu_torch.ops.warp_plain import keys_weight

F32 = np.float32
floats32 = st.floats(width=32, allow_nan=False, allow_infinity=False)
# Source widths up to 2^24 - 2, where w - 1 and w - 2 are exact in float32.
widths = st.integers(min_value=1, max_value=(1 << 24) - 2)


def taps_inside(s: np.float32, w: int, lo: int, hi: int) -> bool:
    """Whether the taps floor(s) + lo .. floor(s) + hi all lie in [0, w)."""
    f = np.floor(s)
    return bool(f + lo >= 0 and f + hi < w)


def interior_2x2(s: np.float32, w: int) -> bool:
    return bool(s >= F32(0.0) and s < F32(w - 1))


def interior_4x4(s: np.float32, w: int) -> bool:
    return bool(s >= F32(1.0) and s < F32(w - 2))


@settings(max_examples=500, deadline=None)
@given(s=floats32, w=widths)
@example(s=-0.0, w=2)
@example(s=float(np.nextafter(F32(0.0), F32(-1.0))), w=2)
@example(s=float(np.nextafter(F32(4.0), F32(0.0))), w=5)
@example(s=4.0, w=5)
def test_bilinear_interior_test_is_the_tap_test(s, w):
    s = F32(s)
    assert interior_2x2(s, w) == taps_inside(s, w, 0, 1)


@settings(max_examples=500, deadline=None)
@given(s=floats32, w=widths)
@example(s=float(np.nextafter(F32(1.0), F32(0.0))), w=4)
@example(s=1.0, w=4)
@example(s=float(np.nextafter(F32(2.0), F32(0.0))), w=4)
@example(s=2.0, w=4)
@example(s=1.5, w=2)
def test_four_tap_interior_test_is_the_tap_test(s, w):
    s = F32(s)
    assert interior_4x4(s, w) == taps_inside(s, w, -1, 2)


def test_interior_tests_near_every_boundary():
    """Every float32 within 64 ulps of 0, 1 and the widths' bounds, for
    widths from 2 to 4099 and at 3840, 4680 and 2^24 - 2."""
    for w in list(range(2, 4100)) + [3840, 4680, (1 << 24) - 2]:
        for edge in {0.0, 1.0, float(w - 2), float(w - 1)}:
            bits = np.array([edge], F32).view(np.int32)[0]
            near = np.arange(bits - 64, bits + 65, dtype=np.int64)
            s = np.concatenate([near[near >= 0], -near[near > 0]]).astype(np.int32).view(F32)
            s = s[np.isfinite(s)]
            f = np.floor(s)
            assert np.array_equal((s >= 0) & (s < F32(w - 1)), (f >= 0) & (f + 1 < w))
            assert np.array_equal((s >= 1) & (s < F32(w - 2)), (f - 1 >= 0) & (f + 2 < w))


def keys_near(t: torch.Tensor) -> torch.Tensor:
    """The kernel's keys_near: ((1.25 t - 2.25) t) t + 1, rounded per step."""
    return ((1.25 * t - 2.25) * t) * t + 1.0


def keys_far(t: torch.Tensor) -> torch.Tensor:
    """The kernel's keys_far: -0.75 (((t - 5) t + 8) t - 4)."""
    return -0.75 * (((t - 5.0) * t + 8.0) * t - 4.0)


def branch_keys(f: torch.Tensor) -> torch.Tensor:
    """The four bicubic weights at offsets -1..2 of fractions ``f`` in
    [0, 1], as ``csrc/warp_modes.cu::weights<BICUBIC>`` takes them."""
    t0, t3 = torch.abs(f + 1.0), torch.abs(f - 2.0)
    zero = torch.zeros_like(f)
    return torch.stack([
        torch.where((t0 > 1.0) & (t0 < 2.0), keys_far(t0), zero),
        keys_near(torch.abs(f - 0.0)),
        keys_near(torch.abs(f - 1.0)),
        torch.where((t3 > 1.0) & (t3 < 2.0), keys_far(t3), zero),
    ])


def plain_keys(f: torch.Tensor) -> torch.Tensor:
    """``warp_plain.keys_weight`` at the four offsets, as the plain 4-tap
    sampler takes it."""
    return torch.stack([keys_weight(f - k) for k in (-1, 0, 1, 2)])


def assert_same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@settings(max_examples=500, deadline=None)
@given(f=st.floats(min_value=0.0, max_value=1.0, width=32))
@example(f=0.0)
@example(f=1.0)
@example(f=float(np.nextafter(F32(1.0), F32(0.0))))
@example(f=float(np.finfo(np.float32).tiny))
@example(f=1e-10)
@example(f=0.5)
def test_branch_selected_keys_is_keys_weight(f):
    x = torch.tensor([f], dtype=torch.float32)
    assert_same_bits(branch_keys(x), plain_keys(x))


def test_branch_selected_keys_over_a_sweep_of_all_fractions():
    """Every 127th float32 bit pattern in [0, 1] (over 8 million), and
    every pattern within 4096 of 0.5, 1 and the smallest normals."""
    top = int(np.array([1.0], np.float32).view(np.int32)[0])
    bits = np.arange(0, top + 1, 127, dtype=np.int64)
    extra = [np.arange(max(0, c - 4096), min(top, c + 4096) + 1)
             for c in (0, top, int(np.array([0.5], np.float32).view(np.int32)[0]), 1 << 23)]
    bits = np.unique(np.concatenate([bits, *extra, [top]])).astype(np.int32)
    f = torch.from_numpy(bits.view(np.float32).copy())
    assert float(f.min()) == 0.0 and float(f.max()) == 1.0
    assert_same_bits(branch_keys(f), plain_keys(f))


def test_fractions_of_floor_lie_in_the_unit_interval():
    """The branch rule's domain: s - floor(s) is in [0, 1] for every finite
    float32 s, 1.0 only where a tiny negative s rounds up to it."""
    g = np.random.default_rng(11)
    bits = g.integers(-(1 << 31), (1 << 31) - 1, size=1 << 20, dtype=np.int64)
    s = bits.astype(np.int32).view(F32)
    s = np.concatenate([s[np.isfinite(s)], -np.logspace(-45, 0, 2000, dtype=F32)])
    f = s - np.floor(s)
    assert f.dtype == F32 and bool((f >= 0).all() and (f <= 1).all())
    assert bool((s[f == 1] < 0).all() and (s[f == 1] > -1e-7).all())
