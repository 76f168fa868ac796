"""Time several builds of K1 (``csrc/warp.cu``) and K2 (``csrc/lk.cu``)
on one card, in turns.

Two versions of a kernel can only be compared inside one process on one
card: cards differ in clocks and power limit. This script compiles each
given source with ``nvcc`` for ``sm_90a`` into a temporary directory, loads
them side by side and times the same launches through each, the builds
taking turns (forwards, then backwards) so that a drift of the clocks falls
on all of them alike::

    python -m video_annotator_tpu_torch.tools.time_warp_builds \\
        [--sass DIR] [label=path/to/warp.cu ...] [label=path/to/lk.cu ...]

The package's own ``warp.cu`` and ``lk.cu`` are always timed, as ``tree``;
each ``label=path`` adds another source of the kind its entry points name
(an earlier commit's ``git show REV:.../warp.cu`` written to a file, a
variant under trial); a label may stand once for each kind. A ``warp.cu``
whose entry points take no ``ny`` argument (before the per-tile-row mode)
is called without it and skipped in the per-tile-row cases; one whose
float entry takes no frame count ``t`` (before the float frame batch) is
called without it.

K1's launches are those of the stock 4K render (3840x2880 fisheye to
4680x3520 rectilinear): the uint8 batch of 1 (row 8's one-frame warp),
4 and 32 frames (the render's batch), luma and chroma, and the float mode on one luma plane
and on a frame's two chroma planes; each with one rotation per frame and
with one per 8-row tile row. Every build must return the same bytes as
``tree``. K2's are level 0 of the main paths at 1920x1440 (a 4K clip
box-downsampled), 8 Newton iterations: the pairs form over the 16 pairs
of a 17-frame chunk with the paired tracker's corners (3200 points) and
the per-frame form on one pair with the sequential tracker's 200; their
guesses come from the coarser levels run through the package's own K2.
K2's sums are taken in another order by another design, so each build
must agree with ``tree`` at ``chip_smoke.py``'s bars: the status of at
least 99% of the points, the flow within 0.01 px where both track.
K1's launches are timed with CUDA events, 20 launches a reading; K2's,
which are near the launch floor, queued behind a sleeping kernel, 100 a
reading. For every case it prints each build's median, least and largest
time over the rounds and the median's ratio to ``tree``. The card's name
and power limit head the output. Under each build stands the number of
machine instructions of each of its kernels (``cuobjdump -sass``; the
uint8 kernel's product build, ``DIAG`` 0, under its name from before the
diagnostic builds, so that counts line up with an earlier source's); with
``--sass DIR`` the listings themselves are written to ``DIR``, one file a
build, to tell a difference in the code from one in its placement.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.camera import CameraPreset
from video_annotator_tpu_torch.io.synthetic import SyntheticSource, render_frame
from video_annotator_tpu_torch.ops import cuda_lib, lk_kernel, warp_kernel
from video_annotator_tpu_torch.ops.corners import detect_corners
from video_annotator_tpu_torch.ops.warp_plain import box_downsample, num_tile_rows
from video_annotator_tpu_torch.pipeline import render
from video_annotator_tpu_torch.tools.roofline import event_ms, queued_ms

W, H = 3840, 2880
WARP_FRAMES = (1, 4, 32)  # 1: row 8's one frame; 32: the render's batch (DEFAULT_WARP_BATCH)
LK_CHUNK = 17  # frames of a paired-analyse chunk
LK_ITERS = 8
PRESET = "gopro_h4b_wide43_measured"
ROUNDS = 12
REPS = 20
LK_REPS = 100
MIN_STATUS_AGREEMENT = 0.99
FLOW_ATOL = 0.01
# The C entry point that tells a source's kind.
KINDS = {"warp": 'extern "C" int vat_warp_u8', "lk": 'extern "C" int vat_lk_level('}
CSRC = {"warp": "warp.cu", "lk": "lk.cu"}


def source_kind(path: Path) -> str:
    text = path.read_text()
    for kind, entry in KINDS.items():
        if entry in text:
            return kind
    raise SystemExit(f"{path} defines neither vat_warp_u8 nor vat_lk_level")


class Build:
    """One compiled ``warp.cu`` and its two entry points."""

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

    def launch(self, src, out, rot, ny, cameras, border):
        """The uint8 entry on (T, P, H, W) bytes, the float one on (P, H, W)."""
        shape = [*src.shape[-3:], *out.shape[-2:]]  # P, in_h, in_w, out_h, out_w
        if src.dtype == torch.uint8:
            fn, shape = self.u8, [src.shape[0]] + shape
        else:
            fn, shape = self.f32, [1] * self.f32_has_t + shape
        if self.has_ny:
            shape.append(ny)
        err = fn(cuda_lib.ptr(src), cuda_lib.ptr(out), cuda_lib.ptr(rot), *shape,
                 *warp_kernel._camera_args(*cameras, border),
                 torch.cuda.current_stream().cuda_stream)
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
        found = re.search(r"Function : \S*?\d((?:warp|lk_level)\w*?_kernel\w*?)Ev?PK", line)
        if found:
            # The uint8 kernel's DIAG = 0 instantiation under its name from
            # before the diagnostic builds (a last template argument 0).
            name = re.sub(r"ELi0EE$", "EE", found.group(1))
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            counts[name] += 1
    return counts


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
        registers = re.findall(r"Used (\d+) registers", out)
        print(f"    registers per kernel, in ptxas's order: {', '.join(registers)}")
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", out)))
        print(f"    spill stores (bytes) per kernel, distinct values: {', '.join(spills)}")
        for kernel, count in sass_counts(nvcc, target, f"{kind}_{label}", sass_dir).items():
            print(f"    {kernel}: {count} instructions")
        builds.append((Build if kind == "warp" else LkBuild)(label, Path(path), target))
    return builds


def synthetic_frames(dev, n: int):
    """(n, 1, H, W) luma and (n, 2, H/2, W/2) chroma of the shaky clip."""
    cfg = SyntheticSource.from_uri(f"synthetic://shaky?w={W}&h={H}&n={n}").config
    frames = [render_frame(cfg.camera(), torch.from_numpy(r).to(dev))
              for r in cfg.rotations()[:n]]
    ys = torch.stack([f[0] for f in frames])[:, None].contiguous()
    uv = torch.stack([torch.stack([f[1], f[2]]) for f in frames]).contiguous()
    return ys, uv


def warp_cases(dev, ys, uv) -> list:
    """(name, src, out, rot, ny, cameras, border) of K1's launches."""
    options = render.RenderOptions(stabilise="smooth", preset=CameraPreset(PRESET))
    in_cam, out_cam = render.build_cameras(render.VideoMeta(W, H, 30, ys.shape[0]), options)
    warper = render.FrameWarper(in_cam, out_cam)
    oh, ow = warper.out_h, warper.out_w
    n = ys.shape[0]
    g = torch.Generator().manual_seed(19)
    base = torch.randn((n, 1, 3), generator=g) * 0.02
    drift = torch.randn((n, 1, 3), generator=g) * 0.02
    ny = num_tile_rows(oh)
    frac = (torch.arange(ny, dtype=torch.float32) / ny)[:, None]
    rows = so3.exp(base + drift * frac).to(dev).contiguous()
    rows_c = warp_kernel.chroma_row_rotations(rows, num_tile_rows(oh // 2)).contiguous()
    luma = ((warper.out_cam, warper.in_cam), (oh, ow), 0.0)
    chroma = ((warper.out_half, warper.in_half), (oh // 2, ow // 2), 128.0)
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
        whole = stack[..., 0, :, :].contiguous()
        cases.append((f"{name}, whole-frame", src, out, whole, 0, cameras, border))
        cases.append((f"{name}, per tile row", src, out, stack.contiguous(),
                      stack.shape[-3], cameras, border))
    return cases


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
    det = box_downsample(grays[:-1], paired.detect_level)
    pts, _ = detect_corners(det, max_corners=render.MAX_CORNERS, min_distance=paired.det_md,
                            border=paired.det_border)
    pts = (pts * paired.det_scale + (paired.det_scale - 1.0) * 0.5).reshape(-1, 2)
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
    turns, forwards then backwards, and print the medians."""
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
        warps = [b for b in builds if b.kind == "warp"]
        lks = [b for b in builds if b.kind == "lk"]
        ys, uv = synthetic_frames(dev, max(WARP_FRAMES))

        for name, src, out, rot, ny, cameras, border in warp_cases(dev, ys, uv):
            def launch(b, src=src, out=out, rot=rot, ny=ny, cameras=cameras, border=border):
                out.zero_()
                b.launch(src, out, rot, ny, cameras, border)
                return out

            print(f"[{name}] {tuple(src.shape)} -> {tuple(out.shape)}")
            time_in_turns(name, [b for b in warps if b.has_ny or ny == 0], launch,
                          lambda fn: event_ms(fn, REPS, 1),
                          lambda got, want: None if torch.equal(got, want) else "bytes differ")

        def lk_check(got, want):
            agree, err = lk_agreement(got, want)
            if agree < MIN_STATUS_AGREEMENT or err > FLOW_ATOL:
                return f"status agreement {agree:.4f}, max |dflow| {err:.2e} px"
            return None

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
