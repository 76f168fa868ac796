"""Time several builds of K1 (``csrc/warp.cu``) on one card, in turns.

Two versions of a kernel can only be compared inside one process on one
card: cards differ in clocks and power limit. This script compiles each
given source with ``nvcc`` for ``sm_90a`` into a temporary directory, loads
them side by side and times the same launches through each, the builds
taking turns (forwards, then backwards) so that a drift of the clocks falls
on all of them alike::

    python -m video_annotator_tpu_torch.tools.time_warp_builds \\
        [--sass DIR] [label=path/to/warp.cu ...]

The package's own source is always timed, as ``tree``; each ``label=path``
adds another (an earlier commit's ``git show REV:.../warp.cu`` written to a
file, a variant under trial). A source whose entry points take no ``ny``
argument (before the per-tile-row mode) is called without it and skipped
in the per-tile-row cases; one whose float entry takes no frame count
``t`` (before the float frame batch) is called without it.

The launches are those of the stock 4K render (3840x2880 fisheye to
4680x3520 rectilinear): the uint8 batch of 4 frames, luma and chroma, and
the float mode on one luma plane and on a frame's two chroma planes; each
with one rotation per frame and with one per 8-row tile row. For every
case it prints each build's median, least and largest time over the rounds
(CUDA events, 20 launches a reading) and the median's ratio to ``tree``.
Every build must also return the same bytes as ``tree``. The card's name
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
from video_annotator_tpu_torch.ops import cuda_lib, warp_kernel
from video_annotator_tpu_torch.ops.warp_plain import num_tile_rows
from video_annotator_tpu_torch.pipeline import render

W, H, FRAMES = 3840, 2880, 4
PRESET = "gopro_h4b_wide43_measured"
ROUNDS = 12
REPS = 20


class Build:
    """One compiled ``warp.cu`` and its two entry points."""

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
        found = re.search(r"Function : \S*?\d(warp\w*?_kernel\w*?)Ev?PK", line)
        if found:
            # The uint8 kernel's DIAG = 0 instantiation under its name from
            # before the diagnostic builds (a last template argument 0).
            name = re.sub(r"ELi0EE$", "EE", found.group(1))
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            counts[name] += 1
    return counts


def compile_all(sources: dict, tmp: Path, sass_dir) -> list:
    """One ``nvcc`` per source, all started together."""
    nvcc = cuda_lib._nvcc()
    procs = {}
    for label, path in sources.items():
        target = tmp / f"libwarp_{label}.so"
        cmd = [nvcc, *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(target), str(path)]
        procs[label] = (target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    builds = []
    for label, (target, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {sources[label]}:\n{out}")
        print(f"[build] {label}: {sources[label]}")
        registers = re.findall(r"Used (\d+) registers", out)
        print(f"    registers per kernel, in ptxas's order: {', '.join(registers)}")
        for kernel, count in sass_counts(nvcc, target, label, sass_dir).items():
            print(f"    {kernel}: {count} instructions")
        builds.append(Build(label, Path(sources[label]), target))
    return builds


def event_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_warp_builds needs a CUDA card", file=sys.stderr)
        return 1
    sources = {"tree": cuda_lib.CSRC_DIR / "warp.cu"}
    sass_dir = None
    if argv[:1] == ["--sass"]:
        sass_dir, argv = Path(argv[1]), argv[2:]
    for arg in argv:
        label, _, path = arg.partition("=")
        if not path or label in sources:
            raise SystemExit(f"expected label=path with labels of their own, got {arg!r}")
        sources[label] = Path(path)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="vat_warp_builds_") as tmp:
        t0 = time.perf_counter()
        builds = compile_all(sources, Path(tmp), sass_dir)
        print(f"[build] {len(builds)} sources in {time.perf_counter() - t0:.1f} s")

        options = render.RenderOptions(stabilise="smooth", preset=CameraPreset(PRESET))
        in_cam, out_cam = render.build_cameras(render.VideoMeta(W, H, 30, FRAMES), options)
        warper = render.FrameWarper(in_cam, out_cam)
        oh, ow = warper.out_h, warper.out_w
        cfg = SyntheticSource.from_uri(f"synthetic://shaky?w={W}&h={H}&n={FRAMES}").config
        frames = [render_frame(cfg.camera(), torch.from_numpy(r).to(dev))
                  for r in cfg.rotations()[:FRAMES]]
        ys = torch.stack([f[0] for f in frames])[:, None].contiguous()
        uv = torch.stack([torch.stack([f[1], f[2]]) for f in frames]).contiguous()
        g = torch.Generator().manual_seed(19)
        base = torch.randn((FRAMES, 1, 3), generator=g) * 0.02
        drift = torch.randn((FRAMES, 1, 3), generator=g) * 0.02
        ny = num_tile_rows(oh)
        frac = (torch.arange(ny, dtype=torch.float32) / ny)[:, None]
        rows = so3.exp(base + drift * frac).to(dev).contiguous()
        rows_c = warp_kernel.chroma_row_rotations(rows, num_tile_rows(oh // 2)).contiguous()
        luma = ((warper.out_cam, warper.in_cam), (oh, ow), 0.0)
        chroma = ((warper.out_half, warper.in_half), (oh // 2, ow // 2), 128.0)
        cases = []
        for name, src, stack, (cameras, size, border) in (
                ("u8 luma, 4 frames", ys, rows, luma),
                ("u8 chroma, 4 frames", uv, rows_c, chroma),
                ("f32 luma, 1 plane", ys[0].float().contiguous(), rows[0], luma),
                ("f32 chroma, 2 planes", uv[0].float().contiguous(), rows_c[0], chroma)):
            out = torch.empty((*src.shape[:-2], *size), dtype=src.dtype, device=dev)
            whole = stack[..., 0, :, :].contiguous()
            cases.append((f"{name}, whole-frame", src, out, whole, 0, cameras, border))
            cases.append((f"{name}, per tile row", src, out, stack.contiguous(),
                          stack.shape[-3], cameras, border))

        for name, src, out, rot, case_ny, cameras, border in cases:
            takers = [b for b in builds if b.has_ny or case_ny == 0]
            want = None
            for b in takers:
                out.zero_()
                b.launch(src, out, rot, case_ny, cameras, border)
                torch.cuda.synchronize()
                if want is None:
                    want = out.clone()
                elif not torch.equal(out, want):
                    raise AssertionError(f"[{name}] {b.label} differs from {takers[0].label}")
            times = {b.label: [] for b in takers}
            for turn in range(ROUNDS):
                for b in (takers if turn % 2 == 0 else takers[::-1]):
                    times[b.label].append(event_ms(
                        lambda: b.launch(src, out, rot, case_ny, cameras, border)))
            tree = statistics.median(times["tree"])
            print(f"[{name}] {tuple(src.shape)} -> {tuple(out.shape)}, "
                  f"{len(takers)} builds with equal output, {ROUNDS} rounds in turns:")
            for label, ms in times.items():
                med = statistics.median(ms)
                print(f"    {label}: median {med:.4f} ms (least {min(ms):.4f}, largest "
                      f"{max(ms):.4f}), ratio to tree {med / tree:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
