"""Time several builds of K1 (``csrc/warp.cu``, ``csrc/warp_modes.cu``)
and K2 (``csrc/lk.cu``) on one card, in turns.

Two versions of a kernel can only be compared inside one process on one
card: cards differ in clocks and power limit. This script compiles each
given source with ``nvcc`` for ``sm_90a`` into a temporary directory, loads
them side by side and times the same launches through each, the builds
taking turns (forwards, then backwards) so that a drift of the clocks falls
on all of them alike::

    python -m video_annotator_tpu_torch.tools.time_warp_builds \\
        [--sass DIR] [label=path/to/warp.cu ...] [label=path/to/warp_modes.cu ...]
        [label=path/to/lk.cu ...]

The package's own ``warp.cu``, ``warp_modes.cu`` and ``lk.cu`` are always
timed, as ``tree``; each ``label=path`` adds another source of the kind its
entry points name (an earlier commit's ``git show REV:.../warp.cu`` written
to a file, a variant under trial); a label may stand once for each kind. A
source includes the ``warp_common.cuh`` beside it. A ``warp.cu`` whose
entry points take no ``ny`` argument (before the per-tile-row mode) is
called without it and skipped in the per-tile-row cases; one whose float
entry takes no frame count ``t`` (before the float frame batch) is called
without it and skipped in the batch and band cases.

K1's launches are those of the stock 4K render (3840x2880 fisheye to
4680x3520 rectilinear): from ``warp.cu``, the uint8 batch of 1 (row 8's
one-frame warp), 4 and 32 frames (the render's batch), luma and chroma,
and the float mode on one luma plane and on a frame's two chroma planes,
each with one rotation per frame and with one per 8-row tile row, the
float frame batch of 8 frames (row 6) and the last of 2 bands of one float
frame (row 9); from ``warp_modes.cu``, the objects that lose the most time
on the main paths (``MODE_CASES``): bicubic on a stereographic grid (float
luma and chroma), the float frame batch on an equirect grid and bicubic,
the uint8 batch in bicubic, lanczos and on an equirect grid at 4 and 32
frames, the one-frame uint8 luma in bicubic, and the float per-tile mip
at ``--scale 0.4``. Every build must return the same bytes as ``tree``.
Three launches of the float luma plane on the stock canvas, bicubic
rectilinear, bilinear and bicubic stereographic, are also traced
(``TRACE``): the share of pixels rendered and of interior pixels, the
source area a pixel covers, and the 32-byte sectors a warp's tap load
touches with one column a thread and with a group of columns a thread.
K2's are level 0 of the main paths at 1920x1440 (a 4K clip
box-downsampled), 8 Newton iterations: the pairs form over the 16 pairs
of a 17-frame chunk with the paired tracker's corners (3200 points) and
the per-frame form on one pair with the sequential tracker's 200; their
guesses come from the coarser levels run through the package's own K2.
K2's sums are taken in another order by another design, so each build
must agree with ``tree`` at ``chip_smoke.py``'s bars: the status of at
least 99% of the points, the flow within 0.01 px where both track.
``warp.cu``'s whole-frame launches are timed with CUDA events, 20
launches a reading; the band, the modes' launches (whose wrapper takes
more host time) and K2's, which is near the launch floor, queued behind a
sleeping kernel. For every case it prints each build's median, least and
largest time over the rounds and the median's ratio to ``tree``. The
card's name and power limit head the output. Under each build stands the
number of machine instructions of each of its kernels (``cuobjdump
-sass``; the uint8 kernel's product build, ``DIAG`` 0, under its name from
before the diagnostic builds, so that counts line up with an earlier
source's); with ``--sass DIR`` the listings themselves are written to
``DIR``, one file a build, to tell a difference in the code from one in
its placement.
"""

from __future__ import annotations

import ctypes
import dataclasses
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch

from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.camera import CameraPreset
from video_annotator_tpu_torch.io.synthetic import SyntheticSource, render_frame
from video_annotator_tpu_torch.ops import cuda_lib, lk_kernel, warp_kernel
from video_annotator_tpu_torch.ops.warp_plain import box_downsample, num_tile_rows
from video_annotator_tpu_torch.pipeline import render
from video_annotator_tpu_torch.tools.roofline import event_ms, queued_ms

W, H = 3840, 2880
WARP_FRAMES = (1, 4, 32)  # 1: row 8's one frame; 32: the render's batch (DEFAULT_WARP_BATCH)
F32_FRAMES = 8  # row 6: the parallel layer's stream batch
BAND_SHARDS = 2  # row 9: the last of this many bands
MODE_FRAMES = (4, 32)
MIP_SCALE = 0.4  # --scale of the prefilter render
# warp_modes.cu's cases: (name, interp, projection, --prefilter, entry, frames);
# entry "u8" a uint8 batch (luma, chroma), "f32" one frame's float planes
# (luma, chroma), "frames" a float frame batch (luma).
MODE_CASES = (
    [("warp_frame_f32_bicubic_rays, warp_planes_f32_bicubic_rays", "bicubic", "stereographic",
      False, "f32", 1),
     ("warp_frames_f32_rays", "bilinear", "equirect", False, "frames", F32_FRAMES),
     ("warp_frames_f32_bicubic", "bicubic", "rect", False, "frames", F32_FRAMES),
     ("warp_yuv_luma_bicubic", "bicubic", "rect", False, "u8 luma", 1)]
    + [(f"warp_{{luma,chroma}}{suffix}", interp, projection, False, "u8", n)
       for interp, projection, suffix in (("bicubic", "rect", "_bicubic"),
                                          ("lanczos", "rect", "_lanczos"),
                                          ("bilinear", "equirect", "_rays"))
       for n in MODE_FRAMES]
    + [("warp_frame_f32_mip, warp_planes_f32_mip", "bilinear", "rect", True, "f32", 1)])
# The stereographic excess: the float luma plane on the stock canvas in
# bicubic rectilinear, bilinear and bicubic stereographic.
TRACE = (("bicubic", "rect"), ("bilinear", "stereographic"), ("bicubic", "stereographic"))
SECTOR = 32  # bytes a load transaction moves
TRACE_GROUP = 8  # columns a thread of the grouped float luma kernels (group_of(1))
LK_CHUNK = 17  # frames of a paired-analyse chunk
LK_ITERS = 8
PRESET = "gopro_h4b_wide43_measured"
ROUNDS = 12
REPS = 20
LK_REPS = 100
MIN_STATUS_AGREEMENT = 0.99
FLOW_ATOL = 0.01
# The C entry point that tells a source's kind.
KINDS = {"warp": 'extern "C" int vat_warp_u8', "lk": 'extern "C" int vat_lk_level(',
         "modes": 'extern "C" int vat_warp_modes('}
CSRC = {"warp": "warp.cu", "lk": "lk.cu", "modes": "warp_modes.cu"}


def source_kind(path: Path) -> str:
    text = path.read_text()
    for kind, entry in KINDS.items():
        if entry in text:
            return kind
    raise SystemExit(f"{path} defines none of vat_warp_u8, vat_lk_level, vat_warp_modes")


class Build:
    """One compiled ``warp.cu`` and its entry points."""

    kind = "warp"

    def __init__(self, label: str, source: Path, lib_path: Path):
        self.label = label
        text = source.read_text()
        head = text[text.index('extern "C" int vat_warp_u8'):]
        self.has_ny = re.search(r"\bint ny\b", head[:head.index("{")]) is not None
        head = text[text.index('extern "C" int vat_warp_f32('):]
        self.f32_has_t = re.search(r"\bint t\b", head[:head.index("{")]) is not None
        lib = ctypes.CDLL(str(lib_path))
        camera = [ctypes.c_float] * 12 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        ints = 7 if self.has_ny else 6
        self.u8, self.f32 = lib.vat_warp_u8, lib.vat_warp_f32
        self.u8.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * ints + camera
        self.f32.argtypes = ([ctypes.c_void_p] * 3
                             + [ctypes.c_int] * (ints - 1 + self.f32_has_t) + camera)
        self.u8.restype = self.f32.restype = ctypes.c_int
        if self.f32_has_t:  # the band came with the frame batch
            self.band = lib.vat_warp_f32_band
            self.band.argtypes = warp_kernel._BAND_ARGTYPES + [ctypes.c_void_p]
            self.band.restype = ctypes.c_int

    def call(self, fn, *args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.label}: launch failed with CUDA error {err}")

    def launch(self, src, out, rot, ny, cameras, border, frames=False):
        """The uint8 entry on (T, P, H, W) bytes, the float one on (P, H, W)
        planes of one frame or, with ``frames``, on (T, H, W) frames."""
        shape = [*src.shape[-3:], *out.shape[-2:]]  # P, in_h, in_w, out_h, out_w
        if src.dtype == torch.uint8:
            fn, shape = self.u8, [src.shape[0]] + shape
        elif frames:
            fn, shape = self.f32, [src.shape[0], 1] + shape[1:]
        else:
            fn, shape = self.f32, [1] * self.f32_has_t + shape
        if self.has_ny:
            shape.append(ny)
        self.call(fn, cuda_lib.ptr(src), cuda_lib.ptr(out), cuda_lib.ptr(rot), *shape,
                  *warp_kernel._camera_args(*cameras, border))

    def launch_band(self, frame, out, rot, cameras, out_h, off):
        """Tile rows [off, off + rows) of one float frame, ``out`` their rows."""
        self.call(self.band, cuda_lib.ptr(frame), cuda_lib.ptr(out), cuda_lib.ptr(rot),
                  *frame.shape, out_h, out.shape[-1], out.shape[0] // 8, off,
                  *warp_kernel._camera_args(*cameras, 0.0))


class ModesBuild:
    """One compiled ``warp_modes.cu``: ``launch`` stands in for a kernel
    object's in ``warp_kernel.launch_modes``."""

    kind = "modes"

    def __init__(self, label: str, source: Path, lib_path: Path):
        self.label = label
        self.fn = ctypes.CDLL(str(lib_path)).vat_warp_modes
        self.fn.argtypes = warp_kernel._MODES_ARGTYPES + [ctypes.c_void_p]
        self.fn.restype = ctypes.c_int

    def launch(self, *args):
        err = self.fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.label}: launch failed with CUDA error {err}")


class LkBuild:
    """One compiled ``lk.cu`` and its two entry points."""

    kind = "lk"

    def __init__(self, label: str, source: Path, lib_path: Path):
        self.label = label
        lib = ctypes.CDLL(str(lib_path))
        p, i = ctypes.c_void_p, ctypes.c_int
        self.pairs, self.frame = lib.vat_lk_level, lib.vat_lk_level_frame
        self.pairs.argtypes = [p, i, p, p, p, i, i, p]
        self.frame.argtypes = [p, p, i, p, p, p, i, i, p]
        self.pairs.restype = self.frame.restype = ctypes.c_int

    def launch(self, prev, nxt, pf, pi, out):
        """The pairs entry where ``nxt`` is None, else the per-frame one."""
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [cuda_lib.ptr(prev)] + ([] if nxt is None else [cuda_lib.ptr(nxt)])
        fn = self.pairs if nxt is None else self.frame
        err = fn(*ptrs, prev.shape[-1], cuda_lib.ptr(pf), cuda_lib.ptr(pi), cuda_lib.ptr(out),
                 pf.shape[0], LK_ITERS, stream)
        if err != 0:
            raise RuntimeError(f"{self.label}: launch failed with CUDA error {err}")


BUILDS = {"warp": Build, "modes": ModesBuild, "lk": LkBuild}


def kernel_name(mangled: str):
    """A kernel's name and template arguments from its mangled name, None
    for another function; the uint8 kernel's DIAG = 0 instantiation under
    its name from before the diagnostic builds (a last template argument
    0), so that counts line up with an earlier source's."""
    found = re.search(r"\d((?:warp|lk_level)\w*?_kernel\w*?)Ev?P[KT]", mangled)
    return re.sub(r"ELi0EE$", "EE", found.group(1)) if found else None


def sass_counts(nvcc: str, lib: Path, label: str, sass_dir) -> dict:
    """Machine instructions per kernel of a built library."""
    tool = Path(nvcc).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    if sass_dir is not None:
        sass_dir.mkdir(parents=True, exist_ok=True)
        (sass_dir / f"{label}.sass").write_text(text)
    counts, name = {}, None
    for line in text.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = kernel_name(found.group(1))
            if name:
                counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    return counts


def ptxas_registers(log: str) -> dict:
    """Registers per kernel from ``nvcc -Xptxas -v``'s report."""
    registers, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = kernel_name(found.group(1))
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            registers[name] = int(found.group(1))
    return registers


def compile_all(sources: dict, tmp: Path, sass_dir) -> list:
    """One ``nvcc`` per source, all started together; ``sources`` maps
    (kind, label) to a path."""
    nvcc = cuda_lib._nvcc()
    procs = {}
    for (kind, label), path in sources.items():
        target = tmp / f"lib{kind}_{label}.so"
        cmd = [nvcc, *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(target), str(path)]
        procs[kind, label] = (target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    builds = []
    for (kind, label), (target, proc) in procs.items():
        out, _ = proc.communicate()
        path = sources[kind, label]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {path}:\n{out}")
        print(f"[build] {kind} {label}: {path}")
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", out)))
        print(f"    spill stores (bytes) per kernel, distinct values: {', '.join(spills)}")
        registers = ptxas_registers(out)
        for kernel, count in sass_counts(nvcc, target, f"{kind}_{label}", sass_dir).items():
            print(f"    {kernel}: {count} instructions, {registers.get(kernel, '?')} registers")
        builds.append(BUILDS[kind](label, Path(path), target))
    return builds


def synthetic_frames(dev, n: int):
    """(n, 1, H, W) luma and (n, 2, H/2, W/2) chroma of the shaky clip."""
    cfg = SyntheticSource.from_uri(f"synthetic://shaky?w={W}&h={H}&n={n}").config
    frames = [render_frame(cfg.camera(), torch.from_numpy(r).to(dev))
              for r in cfg.rotations()[:n]]
    ys = torch.stack([f[0] for f in frames])[:, None].contiguous()
    uv = torch.stack([torch.stack([f[1], f[2]]) for f in frames]).contiguous()
    return ys, uv


@dataclasses.dataclass
class Case:
    """One launch timed through every build of ``kind`` that ``takes`` it:
    ``run(build)`` launches it into ``out``; ``queued``: timed behind a
    sleeping kernel."""

    name: str
    kind: str
    out: torch.Tensor
    run: Callable
    takes: Callable = lambda b: True
    queued: bool = False


def warper(dev, interp="bilinear", projection="rect", prefilter=False):
    """The stock render's FrameWarper, or one in K1's other modes: another
    output projection of the stock canvas, ``--prefilter auto --scale
    0.4``."""
    extra = dict(scale=MIP_SCALE, prefilter="auto") if prefilter else {}
    options = render.RenderOptions(stabilise="smooth", preset=CameraPreset(PRESET),
                                   projection=projection, **extra)
    cams = render.build_cameras(render.VideoMeta(W, H, 30, 1), options)
    return render.FrameWarper(*cams, 8.0, prefilter, interp, dev)


def rotations(dev, n: int, ny: int, seed: int):
    """(n, ny, 3, 3) rotations: a 1 degree pose drifting by another down the
    frame."""
    g = torch.Generator().manual_seed(seed)
    base = torch.randn((n, 1, 3), generator=g) * 0.02
    drift = torch.randn((n, 1, 3), generator=g) * 0.02
    frac = (torch.arange(ny, dtype=torch.float32) / ny)[:, None]
    return so3.exp(base + drift * frac).to(dev).contiguous()


def warp_cases(dev, ys, uv) -> list:
    """``warp.cu``'s launches."""
    w = warper(dev)
    oh, ow = w.out_h, w.out_w
    rows = rotations(dev, ys.shape[0], num_tile_rows(oh), 19)
    rows_c = warp_kernel.chroma_row_rotations(rows, num_tile_rows(oh // 2)).contiguous()
    luma = ((w.out_cam, w.in_cam), (oh, ow), 0.0)
    chroma = ((w.out_half, w.in_half), (oh // 2, ow // 2), 128.0)
    specs = []
    for frames in WARP_FRAMES:
        said = f"{frames} frame" + "s" * (frames > 1)
        specs += [(f"u8 luma, {said}", ys[:frames], rows[:frames], luma),
                  (f"u8 chroma, {said}", uv[:frames], rows_c[:frames], chroma)]
    specs += [("f32 luma, 1 plane", ys[0].float().contiguous(), rows[0], luma),
              ("f32 chroma, 2 planes", uv[0].float().contiguous(), rows_c[0], chroma)]
    cases = []
    for name, src, stack, (cameras, size, border) in specs:
        out = torch.empty((*src.shape[:-2], *size), dtype=src.dtype, device=dev)
        for rs, rot, ny in ((False, stack[..., 0, :, :].contiguous(), 0),
                            (True, stack.contiguous(), stack.shape[-3])):
            cases.append(Case(
                f"{name}, {'per tile row' if rs else 'whole-frame'}", "warp", out,
                lambda b, src=src, out=out, rot=rot, ny=ny, cameras=cameras, border=border:
                b.launch(src, out, rot, ny, cameras, border),
                (lambda b: b.has_ny) if rs else (lambda b: True)))
    frames = ys[:F32_FRAMES, 0].float().contiguous()
    rot = rows[:F32_FRAMES, 0].contiguous()
    out = torch.empty((F32_FRAMES, oh, ow), dtype=torch.float32, device=dev)
    cases.append(Case(f"f32 frame batch, {F32_FRAMES} frames (row 6)", "warp", out,
                      lambda b: b.launch(frames, out, rot, 0, luma[0], 0.0, frames=True),
                      lambda b: b.f32_has_t))
    band_rows = warp_kernel.band_tile_rows(oh, BAND_SHARDS)
    band = torch.empty((band_rows * 8, ow), dtype=torch.float32, device=dev)
    cases.append(Case(f"f32 band, the last of {BAND_SHARDS} (row 9)", "warp", band,
                      lambda b: b.launch_band(frames[0], band, rot[0], luma[0], oh,
                                              (BAND_SHARDS - 1) * band_rows),
                      lambda b: b.f32_has_t, queued=True))
    return cases


def mode_case(dev, name, w, interp, src, rot, cameras, size, border, levels, frames=False):
    """A ``warp_modes.cu`` launch through ``warp_kernel.launch_modes``, the
    levels prepared once."""
    out = torch.empty((*src.shape[:-2], *size), dtype=src.dtype, device=dev)
    stacks = warp_kernel.level_stacks(src, levels, border)
    return Case(name, "modes", out,
                lambda b: warp_kernel.launch_modes(src, out, rot, *cameras, border, interp,
                                                   levels, stacks, b, frames=frames),
                queued=True)


def modes_cases(dev, ys, uv) -> list:
    """``warp_modes.cu``'s launches (``MODE_CASES``)."""
    cases = []
    for name, interp, projection, prefilter, entry, n in MODE_CASES:
        w = warper(dev, interp, projection, prefilter)
        oh, ow = w.out_h, w.out_w
        rot = rotations(dev, n, 1, 29)[:, 0].contiguous()
        luma = ((w.out_cam, w.in_cam), (oh, ow), 0.0, w.levels[0])
        chroma = ((w.out_half, w.in_half), (oh // 2, ow // 2), 128.0, w.levels[1])
        said = f"{interp} {projection}{', mip' if prefilter else ''}"
        if entry == "frames":
            cases.append(mode_case(dev, f"{name}: f32 frame batch, {n} frames, {said}", w, interp,
                                   ys[:n, 0].float().contiguous(), rot, *luma, frames=True))
            continue
        names = name.split(", ") if ", " in name else [name.replace("{luma,chroma}", p)
                                                          for p in ("luma", "chroma")]
        planes = {"u8": (ys[:n], uv[:n]), "u8 luma": (ys[:n],),
                  "f32": (ys[0].float().contiguous(), uv[0].float().contiguous())}[entry]
        for obj, src, geometry in zip(names, planes, (luma, chroma)):
            r = rot if src.dtype == torch.uint8 else rot[0]
            cases.append(mode_case(dev, f"{obj}: {tuple(src.shape)} {src.dtype}, {said}", w,
                                   interp, src, r, *geometry))
    return cases


def trace_cases(dev, ys) -> list:
    """The float luma plane on the stock canvas in each ``TRACE`` mode:
    the launch and, for the trace, (interp, warper, rotation)."""
    src = ys[0].float().contiguous()
    rot = rotations(dev, 1, 1, 41)[0, 0].contiguous()
    cases = []
    for interp, projection in TRACE:
        w = warper(dev, interp, projection)
        case = mode_case(dev, f"trace: f32 luma, {interp} {projection}", w, interp, src, rot,
                         (w.out_cam, w.in_cam), (w.out_h, w.out_w), 0.0, None)
        cases.append((case, (interp, w, rot)))
    return cases


def distinct_per_load(sectors: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Distinct sectors per load instruction: ``sectors`` (..., 32) one warp
    load's lanes, ``valid`` the lanes that load."""
    s = torch.where(valid, sectors, torch.full_like(sectors, -1)).sort(dim=-1).values
    new = torch.ones_like(s, dtype=torch.bool)
    new[..., 1:] = s[..., 1:] != s[..., :-1]
    return (new & (s >= 0)).sum(dim=-1)


def trace_stats(interp: str, w, rot, group: int):
    """What the float luma launch in this mode does per pixel, from its
    plain coordinates: the share of pixels rendered and of interior ones,
    the source area a rendered pixel covers, and the 32-byte sectors of
    the top-left tap row's loads with one column a thread and with
    ``group`` consecutive columns a thread (warp loads with a lane inside
    the image, per rendered pixel; the other tap rows alike). Returns the
    text and the number of rendered pixels."""
    oh, ow, ic = w.out_h, w.out_w, w.in_cam
    coords = warp_kernel.compute_warp_map(w.out_cam, ic, rot, (oh, ow))
    x, y = coords[..., 0], coords[..., 1]
    pad, lo, hi = (0, 0, 1) if interp == "bilinear" else (1, 1, 2)
    valid = (x > -1 - pad) & (x < ic.width + pad) & (y > -1 - pad) & (y < ic.height + pad)
    interior = (x >= lo) & (x < ic.width - hi) & (y >= lo) & (y < ic.height - hi)
    dxu, dyu = x[:-1, 1:] - x[:-1, :-1], y[:-1, 1:] - y[:-1, :-1]
    dxv, dyv = x[1:, :-1] - x[:-1, :-1], y[1:, :-1] - y[:-1, :-1]
    inside = interior[:-1, :-1] & interior[1:, :-1] & interior[:-1, 1:]
    area = (dxu * dyv - dxv * dyu).abs()[inside]
    # the tap at (floor y - pad, floor x - pad): its row's first sector
    first = ((torch.floor(y) - pad) * ic.width + torch.floor(x) - pad) * 4 // SECTOR
    cols = 32 * group
    padw = -ow % cols
    first = torch.nn.functional.pad(first, (0, padw), value=-1).to(torch.int64)
    lanes = torch.nn.functional.pad(valid, (0, padw), value=False)
    one = distinct_per_load(first.reshape(oh, -1, 32), lanes.reshape(oh, -1, 32))
    grouped = distinct_per_load(first.reshape(oh, -1, 32, group).transpose(-1, -2),
                                lanes.reshape(oh, -1, 32, group).transpose(-1, -2))
    rendered = int(valid.sum())
    return (f"{rendered / valid.numel():.4f} of pixels rendered, "
            f"{float(interior.float().mean()):.4f} interior; {float(area.mean()):.4f} source "
            f"pixels a rendered pixel (median {float(area.median()):.4f}); sectors of a tap "
            f"row's loads per rendered pixel: {int(one.sum()) / rendered:.4f} one column a "
            f"thread ({float(one[one > 0].float().mean()):.2f} a warp load), "
            f"{int(grouped.sum()) / rendered:.4f} {group} columns a thread "
            f"({float(grouped[grouped > 0].float().mean()):.2f} a warp load)"), rendered


def level0(levels, pts):
    """Level 0's (prev, nxt, pf, pi) of ``levels`` ((prev, nxt, band) per
    level, None where too small): the guess from the coarser levels through
    the package's own K2, as the trackers run them."""
    flow = torch.zeros_like(pts)
    for lvl in range(len(levels) - 1, 0, -1):
        if levels[lvl] is None:
            continue
        prev, nxt, band = levels[lvl]
        pf, pi, _ = lk_kernel.level_args(prev, pts / 2.0 ** lvl, band, flow / 2.0 ** lvl)
        out = (lk_kernel.lk_level(prev, pf, pi, LK_ITERS) if band is not None
               else lk_kernel.lk_level_frame(prev, nxt, pf, pi, LK_ITERS))
        flow = out[:, :2] * 2.0 ** lvl
    prev, nxt, band = levels[0]
    pf, pi, _ = lk_kernel.level_args(prev, pts, band, flow)
    return prev, None if band is not None else nxt, pf, pi


def lk_cases(dev, lumas) -> list:
    """(name, prev, nxt, pf, pi) of K2's level-0 launches: the pairs form
    (``nxt`` None) on a 17-frame chunk, the per-frame form on one pair."""
    meta = render.VideoMeta(W, H, 30, lumas.shape[0])
    options = render.RenderOptions(stabilise="smooth", preset=CameraPreset(PRESET))
    paired = render.PairTracker(meta, options, dev)
    grays = box_downsample(lumas[:LK_CHUNK].to(torch.float32), paired.level)
    pts = paired.detect(grays[:-1])[0].reshape(-1, 2)
    band = torch.arange(LK_CHUNK - 1, device=dev).repeat_interleave(render.MAX_CORNERS)
    staged = lk_kernel.stage_pyramid_pairs(grays)
    pairs = level0([None if s is None else (s, s, band) for s in staged], pts)
    tracker = render.Tracker(meta, render.RenderOptions(
        stabilise="smooth", preset=CameraPreset(PRESET), analysis_mode="tracked"), dev)
    pts1, _, (_, prev) = tracker.detect(lumas[0])
    _, _, (_, nxt) = tracker.detect(lumas[1])
    frame = level0([None if a is None else (a, b, None) for a, b in zip(prev, nxt)], pts1)
    return [(f"lk pairs, {pairs[2].shape[0]} points, level 0", *pairs),
            (f"lk per frame, {frame[2].shape[0]} points, level 0", *frame)]


def lk_agreement(got, want):
    """(status agreement, largest flow difference where both track)."""
    gs, ws = got[:, 2] > 0.5, want[:, 2] > 0.5
    both = gs & ws
    err = float((got[:, :2] - want[:, :2])[both].abs().max()) if both.any() else 0.0
    return float((gs == ws).float().mean()), err


def time_in_turns(name, takers, launch, timer, check):
    """Check each build's output against the first's, then time them in
    turns, forwards then backwards, and print the medians. Returns the
    medians by label."""
    want = None
    for b in takers:
        got = launch(b)
        torch.cuda.synchronize()
        if want is None:
            want = got.clone()
        else:
            said = check(got, want)
            if said:
                raise AssertionError(f"[{name}] {b.label} differs from {takers[0].label}: {said}")
    times = {b.label: [] for b in takers}
    for turn in range(ROUNDS):
        for b in (takers if turn % 2 == 0 else takers[::-1]):
            times[b.label].append(timer(lambda: launch(b)))
    tree = statistics.median(times["tree"])
    print(f"[{name}] {len(takers)} builds agreeing, {ROUNDS} rounds in turns:")
    for label, ms in times.items():
        med = statistics.median(ms)
        print(f"    {label}: median {med:.4f} ms (least {min(ms):.4f}, largest "
              f"{max(ms):.4f}), ratio to tree {med / tree:.4f}")
    return {label: statistics.median(ms) for label, ms in times.items()}


def run_case(case: Case, builds: list):
    def launch(b):
        case.out.zero_()
        case.run(b)
        return case.out

    print(f"[{case.name}] -> {tuple(case.out.shape)} {case.out.dtype}")
    return time_in_turns(
        case.name, [b for b in builds if b.kind == case.kind and case.takes(b)], launch,
        (lambda fn: queued_ms(fn, REPS)) if case.queued else (lambda fn: event_ms(fn, REPS, 1)),
        lambda got, want: None if torch.equal(got, want) else "bytes differ")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_warp_builds needs a CUDA card", file=sys.stderr)
        return 1
    sources = {(kind, "tree"): cuda_lib.CSRC_DIR / name for kind, name in CSRC.items()}
    sass_dir = None
    if argv[:1] == ["--sass"]:
        sass_dir, argv = Path(argv[1]), argv[2:]
    for arg in argv:
        label, _, path = arg.partition("=")
        key = (source_kind(Path(path)) if path else None, label)
        if not path or key in sources:
            raise SystemExit(f"expected label=path, each label once per kind, got {arg!r}")
        sources[key] = Path(path)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="vat_warp_builds_") as tmp:
        t0 = time.perf_counter()
        builds = compile_all(sources, Path(tmp), sass_dir)
        print(f"[build] {len(builds)} sources in {time.perf_counter() - t0:.1f} s")
        ys, uv = synthetic_frames(dev, max(WARP_FRAMES))
        for case in warp_cases(dev, ys, uv) + modes_cases(dev, ys, uv):
            run_case(case, builds)
        for case, (interp, w, rot) in trace_cases(dev, ys):
            medians = run_case(case, builds)
            said, rendered = trace_stats(interp, w, rot, TRACE_GROUP)
            print(f"[{case.name}] {said}; ns a rendered pixel: " + ", ".join(
                f"{label} {ms * 1e6 / rendered:.4f}" for label, ms in medians.items()))

        def lk_check(got, want):
            agree, err = lk_agreement(got, want)
            if agree < MIN_STATUS_AGREEMENT or err > FLOW_ATOL:
                return f"status agreement {agree:.4f}, max |dflow| {err:.2e} px"
            return None

        lks = [b for b in builds if b.kind == "lk"]
        for name, prev, nxt, pf, pi in lk_cases(dev, ys[:, 0]):
            out = torch.empty((pf.shape[0], 3), dtype=torch.float32, device=dev)

            def launch(b, prev=prev, nxt=nxt, pf=pf, pi=pi, out=out):
                b.launch(prev, nxt, pf, pi, out)
                return out

            print(f"[{name}] {tuple(prev.shape)} staged level, {LK_ITERS} iterations")
            time_in_turns(name, lks, launch, lambda fn: queued_ms(fn, LK_REPS), lk_check)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
