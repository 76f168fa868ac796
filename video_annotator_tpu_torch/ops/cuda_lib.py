"""Build, load and launch the port's hand-written CUDA kernels.

Every kernel lives in ``video_annotator_tpu_torch/csrc/*.cu`` behind a
plain C entry point. On first use each source is compiled with ``nvcc``
for ``sm_90a`` (Hopper), one ``nvcc`` per source, all started together,
and the objects are linked into one shared library under
``video_annotator_tpu_torch/_build/`` (named by a hash of the sources and
flags, so an edited source rebuilds), loaded with ``ctypes``. Nothing
here runs at import time: a host without ``nvcc`` or a card imports this
module fine and only fails when a kernel is launched on a CUDA tensor.

Each C entry point takes the launch stream last and returns
``cudaGetLastError()``; :meth:`CudaKernel.launch` raises on a non-zero
code, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Every kernel object, by name, in the order the modules define them (a
# variant of K1's modes at its first launch, ``warp_kernel.mode_kernel``).
KERNELS: "dict[str, CudaKernel]" = {}


class BuildResult:
    def __init__(self, path: Path, seconds: float, log: str):
        self.path = path
        self.seconds = seconds
        self.log = log


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels of "
            "video_annotator_tpu_torch are built from csrc/ at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def build() -> BuildResult:
    """Compile ``csrc/*.cu`` (once per source digest) and return where the
    library is, how long the build took and what ``nvcc`` printed."""
    target = BUILD_DIR / f"libvat_kernels_{_digest()}.so"
    if target.exists():
        return BuildResult(target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objects, procs = [], []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        objects.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(logs)
    failed = [p.args[-1] for p in procs if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    for obj in objects:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
    os.replace(tmp, target)
    return BuildResult(target, seconds, log)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    lib.vat_error_string.argtypes = [ctypes.c_int]
    lib.vat_error_string.restype = ctypes.c_char_p
    return lib


class CudaKernel:
    """One C entry point of the library, with its launch count.

    ``launches`` counts calls of :meth:`launch` and nothing else, so a
    caller can reset it, run a path, and see which kernels that path ran.
    """

    def __init__(self, name: str, symbol: str, argtypes, source: str,
                 replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
        self.source = source  # the kernel's file in the repository
        self.replaces = replaces  # file:line of the TPU kernel it replaces
        self.launches = 0
        KERNELS[name] = self

    @functools.cached_property
    def _fn(self):
        fn = getattr(library(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args) -> None:
        """Launch on the current stream."""
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, stream)
        self.launches += 1
        if err != 0:
            msg = library().vat_error_string(err).decode()
            raise RuntimeError(f"CUDA kernel {self.name} failed: {msg} ({err})")


def check_cuda(t: torch.Tensor) -> None:
    """Wrappers take CPU tensors (plain version) or CUDA tensors (kernel)."""
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


def check_operands(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous and all share one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


GRAPH_WARMUP = 3  # eager calls on a side stream before a CUDA graph is captured


def graphed(fn, *example: torch.Tensor):
    """``fn`` over tensors shaped as ``example`` (or over none), captured
    once as a CUDA graph and replayed: for a step of many small kernels
    whose launches would otherwise bind it. ``fn`` runs
    :data:`GRAPH_WARMUP` times on a side stream first (on copies of
    ``example``; a stateful ``fn`` takes those calls as its first steps),
    then the returned ``replay(*args)`` copies ``args`` into the static
    inputs, replays, and returns the captured outputs, which the next
    replay overwrites. ``fn`` must not synchronise with the host; other
    threads may use the device during the capture (a prefetcher's copies)."""
    dev = torch.cuda.current_device()
    static = [x.clone() for x in example]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(GRAPH_WARMUP):
            fn(*static)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn(*static)

    def replay(*args):
        for s, a in zip(static, args):
            s.copy_(a)
        graph.replay()
        return out
    return replay
