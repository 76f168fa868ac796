"""Side-by-side comparison grids (the ``--compare`` feature).

Port of ``video_annotator_tpu/pipeline/compare.py``: N stabilisers
rendered into one tiled video. The motion analysis runs once per family,
each mode derives its corrections from its family's trajectory, and the
tiles are assembled on the device, so a frame's canvas crosses to the
host once, on the writer thread.

A rotation cell may level its horizon: ``smooth+lock`` (any rotation
mode with the ``+lock`` suffix) or ``horizon`` (the lock alone, no
stabilisation). The family's analyse then also estimates world-up from
the source's telemetry, where it has any.

On a card a rotation cell warps its float planes through kernel K1's
float mode (``FrameWarper.__call__``: one luma launch, one two-plane
chroma launch) and a similarity cell its uint8 planes through K1's
one-frame uint8 mode (``SimilarityWarper.warp_yuv``); deshake cells, and
every cell on the CPU, use the families' plain torch warps. ``--interp``
reaches the rotation and similarity cells, ``--projection`` and
``--prefilter`` the rotation cells (K1's 4-tap, ray-grid and mip modes);
the level map probes the largest rotation-cell correction.

``--crop W:H[:X:Y]`` takes its rectangle from the whole canvas, sliced on
the device before the readback. ``--debug``, ``--preview`` and
``--display`` leave the grid as it is, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from video_annotator_tpu_torch.io.prefetch import AsyncFrameWriter
from video_annotator_tpu_torch.io.video import VideoMeta, open_reader, open_writer
from video_annotator_tpu_torch.models import FILTER_ALIASES
from video_annotator_tpu_torch.models.deshake import (
    analyse_deshake,
    deshake_corrections,
    warp_frame_deshake,
)
from video_annotator_tpu_torch.models.similarity import (
    SimilarityWarper,
    analyse_similarity,
    similarity_corrections,
    warp_frame_similarity,
)
from video_annotator_tpu_torch.ops.warp_kernel import to_u8
from video_annotator_tpu_torch.pipeline.profiler import Progress, StageProfiler
from video_annotator_tpu_torch.pipeline.render import (
    CropSink,
    FrameWarper,
    RenderOptions,
    TrimmedFrames,
    analyse,
    apply_crop_rect,
    build_cameras,
    compute_corrections,
    max_rotation_deg,
    open_trimmed,
    output_fps,
)
from video_annotator_tpu_torch.pipeline.trajectory import KIND_DIMS, Trajectory


def comparison_grid_size(n: int, cell_aspect: float = 4 / 3) -> tuple:
    """(rows, cols) minimising empty cells, then how far the total canvas
    aspect (``cols * cell_aspect / rows``) lands from a 16:9 display."""
    best = None
    for cols in range(1, n + 1):
        rows = -(-n // cols)
        waste = rows * cols - n
        skew = abs((cols * cell_aspect) / max(rows, 1) - 16 / 9)
        key = (waste, skew)
        if best is None or key < best[0]:
            best = (key, (rows, cols))
    return best[1]


def _parse_mode(m: str):
    """-> (family, stabilise, horizon_lock).

    'none'/'fixed'/'smooth' (rotation family), optionally suffixed
    '+lock' (horizon lock); 'horizon' (rotation family, stabilise none,
    lock on); or a filter family 'vidstab'/'deshake'/'dewobble'[:stabilise]."""
    base, plus, flag = m.partition("+")
    if plus and flag != "lock":
        raise ValueError(f"unknown compare mode suffix {m!r}")
    lock = bool(plus)
    if base == "horizon":
        return "rotation", "none", True
    fam, _, sub = base.partition(":")
    if fam in ("none", "fixed", "smooth"):
        return "rotation", fam, lock
    if fam not in FILTER_ALIASES:
        raise ValueError(f"unknown compare mode {m!r}")
    family = FILTER_ALIASES[fam]
    if lock and family != "rotation":
        raise ValueError(f"'+lock' needs the rotation family (got {m!r})")
    sub = sub or "smooth"
    if sub not in ("none", "fixed", "smooth"):
        # Without this, 2D families would silently smooth on a typo
        # ('vidstab:fixd') while rotation cells raise much later.
        raise ValueError(f"unknown stabilise mode {sub!r} in {m!r}")
    return family, sub, lock


def _label_stamps(labels: Sequence[str], cell_w: int, cell_h: int):
    """Each cell label rendered once as (text mask, outline mask) uint8
    stamps sized to the cell; ``None`` where OpenCV, whose font draws
    them, is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    fs = max(0.45, min(cell_w, cell_h * 4 / 3) / 820.0)
    th = max(1, int(round(fs * 2)))
    stamps = []
    for text in labels:
        (tw, tht), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, fs, th)
        pad = 3 * th
        h = min(tht + base + 2 * pad, cell_h)
        w = min(tw + 2 * pad, cell_w)
        org = (pad, pad + tht)
        outline = np.zeros((h, w), np.uint8)
        cv2.putText(outline, text, org, cv2.FONT_HERSHEY_SIMPLEX, fs, 255,
                    th + 2, cv2.LINE_AA)
        glyph = np.zeros((h, w), np.uint8)
        cv2.putText(glyph, text, org, cv2.FONT_HERSHEY_SIMPLEX, fs, 255, th,
                    cv2.LINE_AA)
        stamps.append((glyph, outline))
    return stamps


def _fit(p: torch.Tensor, h: int, w: int, fill: int) -> torch.Tensor:
    """Centre-crop or pad a plane to the cell size (the 2D families warp
    at the input size, the rotation cells at the output camera's).
    Padding is black for luma (0) and neutral for chroma (128): zero
    chroma would band the cells in saturated green."""
    ph, pw = p.shape
    top = max((ph - h) // 2, 0)
    left = max((pw - w) // 2, 0)
    p = p[top:top + h, left:left + w]
    ph, pw = p.shape
    if ph != h or pw != w:
        oy, ox = (h - ph) // 2, (w - pw) // 2
        canvas = torch.full((h, w), fill, dtype=p.dtype, device=p.device)
        canvas[oy:oy + ph, ox:ox + pw] = p
        p = canvas
    return p


def _tile(planes, rows: int, cols: int, h: int, w: int, fill: int) -> torch.Tensor:
    """(rows * h, cols * w) uint8 canvas of the cells' planes, row-major;
    float planes round half to even and clamp first."""
    canvas = torch.full((h * rows, w * cols), fill, dtype=torch.uint8,
                        device=planes[0].device)
    for i, p in enumerate(planes):
        r, c = divmod(i, cols)
        if p.dtype != torch.uint8:
            p = to_u8(p)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = _fit(p, h, w, fill)
    return canvas


def _label_cells(luma: torch.Tensor, stamps, cols: int, cell_h: int, cell_w: int):
    """Alpha-blend each mode's name (white, black outline) into the
    top-left of its cell, in place: luma only, so the text is colourless."""
    for i, (glyph, outline) in enumerate(stamps):
        r, c = divmod(i, cols)
        sh, sw = glyph.shape
        region = luma[r * cell_h:r * cell_h + sh, c * cell_w:c * cell_w + sw]
        blended = region.to(torch.int32) * (255 - outline) // 255
        blended = (blended * (255 - glyph) + 255 * glyph) // 255
        region.copy_(blended.to(torch.uint8))


def render_compare(source: str, dest: Optional[str], modes: Sequence[str],
                   options: RenderOptions,
                   profiler: Optional[StageProfiler] = None,
                   device="cuda") -> None:
    """Render each mode into one tiled output video.

    Modes are stabilise settings of the rotation family ('none', 'fixed',
    'smooth') and/or other filter families ('vidstab', 'deshake',
    optionally 'family:stabilise'): the 4-way grid is ``--compare
    none,smooth,vidstab,deshake``. Analysis runs once per family; all
    rotation cells share one trajectory."""
    prof = profiler or StageProfiler()
    dev = torch.device(device)
    if options.rolling_shutter:
        raise ValueError(
            "--rolling-shutter is not supported with --compare (cells "
            "warp with whole-frame poses); render modes separately")
    parsed = [_parse_mode(m) for m in modes]
    fams = {f for f, _, _ in parsed}
    reader, meta, first, last = open_trimmed(source, options, dev)

    def count_frames() -> int:
        """Frames of the trim window (``last`` is exclusive): placeholder
        trajectories must cover what the analysers would, and a source
        without a frame count is counted by decoding it once."""
        if last < (1 << 30) and meta.num_frames:
            return max(0, last - first)
        r = open_reader(source, device="cpu", prefer_native=options.native_io)
        n = sum(1 for _ in r)
        r.close()
        return max(0, min(last, n) - first)

    trajs = {}
    any_lock = any(lock for _, _, lock in parsed)
    if "rotation" in fams:
        # Locked cells need the measured attitude (and the telemetry's
        # up vector where present) even at stabilise none.
        if any(s != "none" or lock for f, s, lock in parsed if f == "rotation"):
            trajs["rotation"] = analyse(
                source, dataclasses.replace(
                    options, horizon_lock=options.horizon_lock or any_lock),
                prof, device=dev)
        else:
            trajs["rotation"] = Trajectory(
                np.zeros((count_frames(), KIND_DIMS["so3"])), "so3", meta.fps,
                meta.width, meta.height, source)
    if "similarity" in fams:
        trajs["similarity"] = analyse_similarity(source, options, prof, device=dev)
    if "deshake" in fams:
        trajs["deshake"] = analyse_deshake(source, options, prof, device=dev)

    # The shared grid canvas includes the stabilise-buffer zoom when any
    # rotation cell stabilises or levels; a standalone render gets it from
    # its own options.stabilise.
    any_rot_stab = any(f == "rotation" and (s != "none" or lock)
                       for f, s, lock in parsed)
    in_cam, out_cam = build_cameras(
        meta, dataclasses.replace(options, stabilise="smooth")
        if any_rot_stab and options.stabilise == "none" else options)
    corrections = {
        "rotation": lambda traj, o: compute_corrections(traj, o, dev),
        "similarity": similarity_corrections,
        "deshake": deshake_corrections,
    }
    per_mode = []
    need_deg = 0.0  # the largest rotation-cell correction
    for fam, sub, lock in parsed:
        corr = corrections[fam](trajs[fam], dataclasses.replace(
            options, stabilise=sub,
            horizon_lock=(options.horizon_lock or lock) if fam == "rotation" else False))
        if fam == "rotation":
            need_deg = max(need_deg, max_rotation_deg(corr))
        if fam == "similarity" and dev.type == "cuda":
            corr = SimilarityWarper.matrices(corr)
        per_mode.append((fam, torch.from_numpy(np.asarray(corr, np.float32)).to(dev)))
    num_frames = min(t.num_frames for t in trajs.values()) if trajs else 0

    warper = FrameWarper(in_cam, out_cam, max(options.max_correction_deg, need_deg + 0.5),
                         options.prefilter == "auto", options.interp, dev)
    sim_warper = SimilarityWarper(meta.width, meta.height, interp=options.interp)
    rows, cols = comparison_grid_size(len(modes))
    cell_h, cell_w = warper.out_h, warper.out_w
    stamps = _label_stamps(list(modes), cell_w, cell_h) if options.cell_labels else None
    if stamps:
        stamps = [tuple(torch.from_numpy(s.astype(np.int32)).to(dev) for s in pair)
                  for pair in stamps]
    out_meta = VideoMeta(cell_w * cols, cell_h * rows, output_fps(options, meta),
                         num_frames)
    write_meta, crop_r = apply_crop_rect(out_meta, options)
    writer = AsyncFrameWriter(open_writer(None if options.no_output else dest,
                                          write_meta, encoder=options.encoder), profiler=prof)
    if crop_r:  # the canvas's rectangle, sliced on the device before the readback
        writer = CropSink(writer, crop_r)

    def warp_cell(fam, corr, planes_u8, planes_f32):
        if fam == "rotation":
            return warper(*planes_f32, corr)
        if fam == "similarity" and dev.type == "cuda":
            return sim_warper.warp_yuv(*planes_u8, corr)
        if fam == "similarity":
            return warp_frame_similarity(*planes_f32, corr, interp=options.interp)
        return warp_frame_deshake(*planes_f32, corr)

    # The trim window is honoured as the analysers do: corrections index
    # from its first frame, to which the reader was opened.
    t = 0
    prog = Progress("compare", total=num_frames)
    try:
        with TrimmedFrames(reader, first, last, options, dev, prof) as frames:
            for planes_u8 in frames:
                if t >= num_frames:
                    break
                with prof.stage("warp"):
                    planes_f32 = tuple(p.to(torch.float32) for p in planes_u8)
                    cells = [warp_cell(fam, corr[t], planes_u8, planes_f32)
                             for fam, corr in per_mode]
                    ys, us, vs = zip(*cells)
                    luma = _tile(ys, rows, cols, cell_h, cell_w, 0)
                    if stamps:
                        _label_cells(luma, stamps, cols, cell_h, cell_w)
                    canvas = (luma,
                              _tile(us, rows, cols, cell_h // 2, cell_w // 2, 128),
                              _tile(vs, rows, cols, cell_h // 2, cell_w // 2, 128))
                with prof.stage("encode"):
                    writer.write(canvas)
                t += 1
                prog.tick()
    except BaseException:
        try:
            writer.close()
        except Exception:
            pass
        raise
    prog.close()
    with prof.stage("encode"):
        writer.close()
    if options.verbose:
        print(prof.report())
