"""``--debug``: stabilisation diagnostics drawn into the output video.

Port of ``video_annotator_tpu/pipeline/debug.py``. The reference forwards
``--debug`` into its filters, which draw their internal state over the
frames (``libdewobble``'s ``debug: 1``, ``src/render.ts:677``;
``deshake_opencl``'s point and transform overlay, ``src/render.ts:891``).
Here the HUD is drawn with OpenCV on the host, on the writer thread,
where the frames already are numpy planes: the frame's correction as
text, and under the two-phase renders the measured and correction
curves over the whole clip with a cursor at the frame.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def rotation_angles_deg(mats: np.ndarray) -> np.ndarray:
    """(T,) rotation angles in degrees of (T, 3, 3) matrices."""
    tr = np.trace(mats, axis1=-2, axis2=-1)
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


class DebugOverlayWriter:
    """Frame sink decorator: draw the HUD on the luma, then write.

    Sits under :class:`AsyncFrameWriter`, so it draws on the writer
    thread after the readback. ``curves``: per-frame series over the
    whole clip to plot (the two-phase renders know the trajectory up
    front). ``text`` maps a frame index to its HUD line; the streaming
    render fills an entry in just before it queues the frame."""

    def __init__(self, sink, total: Optional[int] = None,
                 curves: Optional[Dict[str, np.ndarray]] = None):
        self._sink = sink
        self._t = 0
        self._total = total
        self._curves = {k: np.asarray(v, np.float64) for k, v in (curves or {}).items()
                        if v is not None and len(v)}
        self.text: Dict[int, str] = {}

    def write(self, planes):
        import cv2

        y, u, v = (np.clip(np.round(np.asarray(p)), 0, 255).astype(np.uint8)
                   for p in planes)
        y = np.ascontiguousarray(y)
        h, w = y.shape
        t = self._t
        scale = max(w / 1280.0, 0.35)

        line = self.text.pop(t, None)
        if line is None:
            line = f"frame {t}"
        cv2.putText(y, line, (int(8 * scale), int(28 * scale)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.7 * scale, 255,
                    max(1, int(round(2 * scale))), cv2.LINE_AA)

        if self._curves:
            strip = max(24, h // 8)
            top = h - strip
            # Darken the strip so that every curve's shade reads on any footage.
            y[top:, :] = (y[top:, :] * 0.35).astype(np.uint8)
            total = self._total or max(len(next(iter(self._curves.values()))), 1)
            peak = max(max(float(np.max(np.abs(c))) for c in self._curves.values()), 1e-6)
            for k, ((name, c), shade) in enumerate(zip(self._curves.items(),
                                                       (255, 160, 96))):
                xs = np.arange(len(c)) * (w - 1) / max(total - 1, 1)
                ys = top + (strip - 2) * (1.0 - np.abs(c) / peak)
                pts = np.stack([xs, ys], axis=1).astype(np.int32)
                cv2.polylines(y, [pts], False, int(shade), 1, cv2.LINE_AA)
                cv2.putText(y, f"{name} (peak {peak:.2f})",
                            (int(8 * scale), top + int(14 * scale) * (k + 1)),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.45 * scale, int(shade), 1,
                            cv2.LINE_AA)
            cx = int(min(t, total - 1) * (w - 1) / max(total - 1, 1))
            y[top:, cx:cx + 1] = 255
        self._t += 1
        self._sink.write((y, u, v))

    def close(self):
        self._sink.close()
