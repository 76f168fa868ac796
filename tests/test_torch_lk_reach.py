"""The reach of K2's window reads, on its plain version.

``csrc/lk.cu`` copies each point's 48 x 256 next-frame window into shared
memory once and reads it in the Newton iterations without clamps. That is
sound because the drift clamp (``oy`` in [1, 24], ``ox`` in [1, 233]) keeps
every iteration read inside rows [1, 45] and columns [1, 254] of the
window, whatever the guesses and the flows. These tests pin that on
:func:`lk_kernel.lk_level_plain`, which mirrors the kernel's clamps, by
recording the raw rows and columns it asks of each window before its own
clamp. The template's reads of the prev window are not bounded so, and
the kernel keeps their clamps: the last test shows one leave the window.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from video_annotator_tpu_torch.ops import lk_kernel

ITER_ROWS = (1, 45)  # the rows [1, 45] the iterations may read
ITER_COLS = (1, 254)  # and the columns [1, 254]


def recorded_reads(monkeypatch):
    """Patch the plain version's window sampler to record, per window it
    opens (prev first, then next), the extreme raw rows and columns read."""
    real = lk_kernel._sampler
    windows = []

    def sampler(stack, row0, col0):
        at = real(stack, row0, col0)
        reads = []
        windows.append(reads)

        def recording(y, x):
            reads.append((int(y.min()), int(y.max()), int(x.min()), int(x.max())))
            return at(y, x)

        return recording

    monkeypatch.setattr(lk_kernel, "_sampler", sampler)
    return windows


def extent(reads):
    return (min(r[0] for r in reads), max(r[1] for r in reads),
            min(r[2] for r in reads), max(r[3] for r in reads))


def level_inputs(seed: int, form: str, n: int, guess_scale: float, noise: float):
    """A staged level of random frames (smooth texture plus noise, so that
    Newton steps go anywhere), ``n`` points over and beyond the image and
    guesses of ``guess_scale``; the (pf, pi) arguments of one level."""
    rng = np.random.default_rng(seed)
    h, w = 136, 300
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for _ in range(3):
        a, b = rng.uniform(3, 9, 2)
        img = 128 + 60 * np.sin(xx / a + rng.uniform(0, 6)) * np.cos(yy / b)
        frames.append(img + noise * rng.standard_normal((h, w)))
    frames = torch.from_numpy(np.clip(np.stack(frames), 0, 255).astype(np.float32))
    pts = torch.from_numpy(rng.uniform([-40, -40], [w + 40, h + 40], (n, 2)).astype(np.float32))
    guess = torch.from_numpy((rng.standard_normal((n, 2)) * guess_scale).astype(np.float32))
    if form == "pairs":
        stack = lk_kernel.stage_pyramid_pairs(frames, levels=1)[0]
        band = torch.from_numpy(rng.integers(0, 2, n))
        pf, pi, _ = lk_kernel.level_args(stack, pts, band, guess)
        return stack, stack, pf, pi
    prev, nxt = (lk_kernel.stage_pyramid(f, levels=1)[0] for f in frames[:2])
    pf, pi, _ = lk_kernel.level_args(prev, pts, None, guess)
    return prev, nxt, pf, pi


@pytest.mark.parametrize("form", ["pairs", "frame"])
@pytest.mark.parametrize("guess_scale", [0.0, 4.0, 1e3, 1e6])
@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), noise=st.sampled_from([0.0, 20.0, 120.0]))
def test_iteration_reads_stay_inside_the_next_window(form, guess_scale, seed, noise):
    prev, nxt, pf, pi = level_inputs(seed, form, 24, guess_scale, noise)
    with pytest.MonkeyPatch.context() as mp:
        windows = recorded_reads(mp)
        out = lk_kernel.lk_level_plain(prev, nxt, pf, pi, 8)
    assert torch.isfinite(out).all()
    assert len(windows) == 2
    y0, y1, x0, x1 = extent(windows[1])
    assert ITER_ROWS[0] <= y0 and y1 <= ITER_ROWS[1], (y0, y1)
    assert ITER_COLS[0] <= x0 and x1 <= ITER_COLS[1], (x0, x1)
    assert 0 <= y0 and y1 < lk_kernel.AW * 4 and 0 <= x0 and x1 < lk_kernel.WCOLS


@pytest.mark.parametrize("flow", [-1e30, -1e6, -50.0, 0.0, 50.0, 1e6, 1e30])
def test_drift_clamp_bounds_the_reads_for_any_flow(monkeypatch, flow):
    """Flows of any finite size, put directly into the guess and the next
    window's corner: the clamp holds the reads in the same rows and
    columns, and the status is cleared where it bites."""
    prev, nxt, pf, pi = level_inputs(3, "frame", 8, 0.0, 20.0)
    pf = pf.clone()
    pf[:, 0] = pf[:, 1] = flow  # the guess: the drift starts at 0
    pf[:, 4] += flow  # the next window's corner moved by the flow
    pf[:, 5] -= flow
    windows = recorded_reads(monkeypatch)
    out = lk_kernel.lk_level_plain(prev, nxt, pf, pi, 8)
    y0, y1, x0, x1 = extent(windows[1])
    assert ITER_ROWS[0] <= y0 and y1 <= ITER_ROWS[1]
    assert ITER_COLS[0] <= x0 and x1 <= ITER_COLS[1]
    if abs(flow) >= 50.0:
        assert not (out[:, 2] > 0.5).any()


def test_template_reads_may_leave_the_prev_window(monkeypatch):
    """The template's corner is not clamped: a corner near the window's
    edge reads past it, which the kernel's Window::at clamps as the plain
    version does; those reads stay on global memory."""
    prev, nxt, pf, pi = level_inputs(5, "frame", 4, 0.0, 0.0)
    pf = pf.clone()
    pf[:, 2] = torch.tensor([-3.0, 30.0, 0.5, 40.0])  # ry prev
    pf[:, 3] = torch.tensor([-2.0, 240.0, 0.5, 1.0])  # ix prev
    windows = recorded_reads(monkeypatch)
    lk_kernel.lk_level_plain(prev, nxt, pf, pi, 8)
    y0, y1, x0, x1 = extent(windows[0])
    assert y0 < 0 or y1 >= lk_kernel.AW * 4
    assert x0 < 0 or x1 >= lk_kernel.WCOLS
