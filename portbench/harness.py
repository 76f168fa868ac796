"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything that belongs to a configuration, a traffic mix or a metric is
data found by name: ``configs/<config>.json`` (the file ``BENCHMARK.json``
names), ``mixes/<traffic>.json`` and ``metrics/<metric>.py`` (or, for
``base.suffix``, ``metrics/<base>.py``).

The window drives ``video_annotator_tpu_torch.pipeline.render.render`` in a
closed loop, one job at a time, each job the whole clip, with the options
the CLI's own parser builds from the configuration's and the mix's command
line. A job's output goes to a FIFO that the collector process reads.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from portbench import generator, reference, trajfile
from portbench.trace import DeviceTrace, kineto_device_events

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "video_annotator_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_plan(bench: dict, workload: str) -> SimpleNamespace:
    """The cell's configuration, mix and metrics, from ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def applies(metric, moves_ok=True):
        return workload in metric["workloads"] if "workloads" in metric else moves_ok

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, m["moves"] in e2e_names)]
    return SimpleNamespace(name=workload, chips=int(cell["chips"]),
                           cfg=load_json(ROOT / config["file"]),
                           mix=load_json(HERE / "mixes" / f"{cell['traffic']}.json"),
                           end_to_end=e2e, per_layer=per_layer)


def reader(name: str):
    """``metrics/<name>.py``, else ``metrics/<base>.py`` for ``base.suffix``."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"portbench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {HERE / 'metrics'}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Collector:
    """The collector process and the FIFOs it reads."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.proc = subprocess.Popen([sys.executable, str(HERE / "collector.py")],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self.fifo = None
        self._watch = threading.Thread(target=self._unblock_on_exit, daemon=True)
        self._watch.start()

    def _unblock_on_exit(self):
        """Should the collector die, open the FIFO for reading so that the
        render's open for writing returns and its writes fail."""
        self.proc.wait()
        fifo = self.fifo
        if fifo and os.path.exists(fifo):
            with contextlib.suppress(OSError):
                os.close(os.open(fifo, os.O_RDONLY | os.O_NONBLOCK))

    def expect(self, name: str, sample) -> str:
        path = os.path.join(self.workdir, name)
        os.mkfifo(path)
        self.fifo = path
        self.proc.stdin.write((json.dumps({"fifo": path, "sample": sorted(sample)}) + "\n")
                              .encode())
        self.proc.stdin.flush()
        return path

    def finish(self):
        """(per-job summaries, kept frames as bytes)."""
        self.proc.stdin.write(b'{"stop": true}\n')
        self.proc.stdin.flush()
        jobs = json.loads(self.proc.stdout.readline())
        frames = []
        for job in jobs:
            size = job["width"] * job["height"] * 3 // 2
            for _ in job["kept"]:
                frames.append(self.proc.stdout.read(size))
        self.proc.wait()
        return jobs, frames

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def span_profiler():
    """A ``StageProfiler`` that also keeps each stage's wall-clock span
    while ``spans`` is a list (the traced window)."""
    from video_annotator_tpu_torch.pipeline.profiler import StageProfiler

    class SpanProfiler(StageProfiler):
        spans = None

        @contextlib.contextmanager
        def stage(self, name):
            spans = self.spans
            t0 = time.time_ns()
            try:
                with super().stage(name):
                    yield
            finally:
                if spans is not None:
                    spans.append((name, t0, time.time_ns()))

    return SpanProfiler()


def wants_device_trace(plan, trace: bool) -> bool:
    """Whether the window is traced on the device: always with ``--trace 1``,
    and with ``--trace 0`` where an end-to-end metric reads the trace."""
    return trace or any(m["source"] == "device_trace" for m in plan.end_to_end)


def stage_delta(after, before) -> dict:
    sec1, n1 = after
    sec0, n0 = before
    return {k: (sec1[k] - sec0.get(k, 0.0), n1[k] - n0.get(k, 0)) for k in sec1}


def sample_frames(seed: int, job: int, frames: int, count: int) -> set:
    """``count`` frame indices of a job drawn from the seed, the last frame
    (the padded tail of the last batch) always among them."""
    rng = np.random.default_rng([seed, job])
    picks = rng.choice(frames - 1, size=min(count - 1, frames - 1), replace=False)
    return {int(i) for i in picks} | {frames - 1}


def render_options(args: list):
    from video_annotator_tpu_torch import cli

    return cli._render_options(cli.build_parser().parse_args(["render", *args]))


def run_cell(plan, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, warmup: bool = True) -> dict:
    """Run ``plan`` once; returns the result line's fields and the checks.
    ``warmup=False`` (a process that has run the cell before) skips the
    warm-up job.

    ``setup_s`` is ``t_start`` to the window's start less the benchmark's
    own work, which no user of the program pays: the collector's start, the
    clip's render, its write, the truth file and the profiler's start. The clip is made after the
    CUDA context and before the warm-up job, through pageable host memory,
    and the device memory it cached is given back, so that the warm-up job
    grows the program's allocators itself."""
    from video_annotator_tpu_torch.pipeline.render import render

    parts = {"imports": time.monotonic() - t_start}
    cfg, mix = plan.cfg, plan.mix
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from video_annotator_tpu_torch.ops import cuda_lib

        t = time.monotonic()
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        parts["CUDA context"] = time.monotonic() - t
        t = time.monotonic()
        cuda_lib.library()
        parts["kernels"] = time.monotonic() - t
    workdir = tempfile.mkdtemp(prefix="portbench-", dir=tempfile.gettempdir())
    collector = None
    try:
        t_inputs = time.monotonic()
        collector = Collector(workdir)  # its interpreter starts while the clip is made
        clip = generator.Clip(cfg, seed)
        src = os.path.join(workdir, "clip.y4m")
        clip_bytes = clip.write_y4m(src, device)
        truth_file = None
        if mix["trajectory_input"]:
            truth_file = os.path.join(workdir, "truth.traj.npz")
            trajfile.write(truth_file, reference.truth_params(clip.rotvecs), clip.fps,
                           clip.width, clip.height, src)
        if cuda:
            torch.cuda.empty_cache()
        t_inputs = time.monotonic() - t_inputs
        t = time.monotonic()
        prof = span_profiler()
        base = [src, "out.y4m", *cfg["render_args"], *mix["render_args"]]
        if not cuda:
            base += ["--device", "cpu"]
        options = render_options(base)
        parts["options"] = time.monotonic() - t

        def job(name, sample=()):
            dest = (collector.expect(name, sample) if mix["frames_out"]
                    else os.path.join(workdir, name))
            if truth_file:
                os.link(truth_file, trajfile.path_for(dest))
            render(src, dest, options, prof, device=device)
            return dest

        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t = time.monotonic()
        if warmup:  # a whole job: every ring, pool and allocator at a window job's depth
            job("warmup.y4m")
        if cuda:
            torch.cuda.synchronize()
        parts["warm-up job"] = time.monotonic() - t

        setup_s = time.monotonic() - t_start - t_inputs
        t = time.monotonic()
        profiler = None
        if cuda and wants_device_trace(plan, trace):
            profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            profiler.__enter__()
            if trace:
                prof.spans = []
                torch.cuda.reset_peak_memory_stats()
        print("[portbench] set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in parts.items())
              + f"; setup_s {setup_s:.2f} s. Outside it: collector and clip {t_inputs:.2f} s, "
              f"{clip_bytes} bytes; the profiler's start {time.monotonic() - t:.2f} s",
              file=sys.stderr)
        stages0 = prof.all_totals()
        jobs, failed = [], 0
        t0 = time.monotonic()
        w0_ns = time.time_ns()
        while True:
            k = len(jobs)
            sample = (sample_frames(seed, k, clip.frames, mix["sample_frames_per_job"])
                      if mix["frames_out"] else ())
            js = time.monotonic()
            try:
                dest = job(f"job{k}.y4m", sample)
            except Exception:  # counted as failed; the run is then not correct
                print(f"[portbench] job {k} failed:", file=sys.stderr)
                traceback.print_exc()
                failed += 1
                jobs.append({"start": js, "end": time.monotonic(), "dest": None})
                break
            if cuda:
                torch.cuda.synchronize()
            jobs.append({"start": js, "end": time.monotonic(), "dest": dest})
            if jobs[-1]["end"] - t0 >= seconds:
                break
        t1 = jobs[-1]["end"]
        w1_ns = time.time_ns()
        stages = stage_delta(prof.all_totals(), stages0)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        device_trace = None
        if profiler is not None:
            tr = time.monotonic()
            profiler.__exit__(None, None, None)
            events = kineto_device_events(profiler, names=trace)
            del profiler
            device_trace = DeviceTrace(events, w0_ns, w1_ns, prof.spans or ())
            print(f"[portbench] trace: {len(events)} device events read in "
                  f"{time.monotonic() - tr:.1f} s", file=sys.stderr)
        found = forbidden_modules()
        if failed:
            collector.kill()
            summaries, kept = [], []
        else:
            summaries, kept = collector.finish()
            if warmup:
                summaries = summaries[1:]  # the warm-up job's output
        collector = None
        for k, j in enumerate(jobs):
            print(f"[portbench] job {k}: {j['end'] - j['start']:.3f} s", file=sys.stderr)
        print(f"[portbench] window {t1 - t0:.3f} s, stage seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, (v, _) in sorted(stages.items(), key=lambda kv: -kv[1][0])),
            file=sys.stderr)
        del prof
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        checks, params = check(plan, clip, src, jobs, summaries, kept, truth_file, device)
        ctx = SimpleNamespace(
            frames_analysed=sum(len(p) for p in params.values()),
            plan=plan, cfg=cfg, mix=mix, clip=clip, jobs=jobs, summaries=summaries,
            window_s=t1 - t0, setup_s=setup_s, stages=stages, trace=device_trace,
            peak_bytes=peak, warp=reference.Warp(clip.camera, cfg["stabilise_buffer_percent"]),
            warp_batch=int(cfg["warp_batch"]))
        metrics = {}
        for m in (plan.per_layer if trace else plan.end_to_end):
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out = {"attempted": len(jobs), "failed": failed, "metrics": metrics,
               "checks": checks, "forbidden": found, "peak_bytes": peak,
               "trace": device_trace if trace else None}
        return out
    finally:
        if collector is not None:
            collector.kill()
        for name in os.listdir(workdir):
            os.remove(os.path.join(workdir, name))
        os.rmdir(workdir)


def check(plan, clip, src, jobs, summaries, kept, truth_file, device) -> dict:
    """Each number compared, with its limit (``limits`` of the
    configuration): the trajectories against the truth, every frame
    delivered at the output size, the sampled frames against the
    reference warp. Also returns each job's trajectory, by job."""
    cfg, mix = plan.cfg, plan.mix
    limits = cfg["limits"]
    done = [j for j in jobs if j["dest"]]
    checks = {"jobs_failed": (len(jobs) - len(done), 0)}
    expect = reference.expected_rotations(clip.rotvecs)
    params = {}
    if mix["analyses"]:
        missing, rms, worst = 0, 0.0, 0.0
        for k, j in enumerate(done):
            try:
                p = trajfile.read_params(trajfile.path_for(j["dest"]))
            except (OSError, ValueError, KeyError) as e:
                print(f"[portbench] job {k}: no trajectory ({e!r})", file=sys.stderr)
                missing += clip.frames
                continue
            params[k] = p
            missing += abs(len(p) - clip.frames)
            err = reference.angle_errors_deg(p[:clip.frames], expect)
            rms = max(rms, float(np.sqrt(np.mean(err ** 2))) if len(err) else math.inf)
            worst = max(worst, float(err.max()) if len(err) else math.inf)
        checks["traj_frames_missing"] = (missing, limits["traj_frames_missing"])
        checks["traj_rms_deg"] = (rms, limits["traj_rms_deg"])
        checks["traj_max_deg"] = (worst, limits["traj_max_deg"])
    if mix["frames_out"]:
        warp = reference.Warp(clip.camera, float(cfg["stabilise_buffer_percent"]))
        size = (warp.out_w, warp.out_h)
        wins = summaries
        missing = sum(clip.frames if (s["width"], s["height"]) != size
                      else abs(clip.frames - s["frames"]) + s["bad"] for s in wins)
        missing += clip.frames * (len(done) - len(wins))
        checks["frames_missing"] = (missing, limits["frames_missing"])
        checks["frame_max_diff"] = (frame_max_diff(
            plan, clip, src, wins, kept, warp, params, truth_file, device), limits["frame_max_diff"])
    return checks, params


def frame_max_diff(plan, clip, src, wins, kept, warp, params, truth_file, device) -> int:
    """The largest difference, in counts, of a sampled frame's planes from
    the reference's warp of the same source frame with the corrections the
    reference works out from the job's trajectory (the encode-only input,
    or the trajectory the job wrote)."""
    radius = int(plan.cfg["stabilise_radius"])
    frames = iter(kept)  # the warm-up job keeps none
    worst = 0
    ysize = warp.out_w * warp.out_h
    csize = ysize // 4
    dev = torch.device(device)
    for k, s in enumerate(wins):
        p = trajfile.read_params(truth_file) if truth_file else params.get(k)
        corr = reference.corrections(p, radius) if p is not None else None
        for idx in s["kept"]:
            got = np.frombuffer(next(frames), np.uint8)
            if corr is None or idx >= len(corr):
                return 255
            y, u, v = read_y4m_frame(src, clip, idx, dev)
            want = warp.frame(y, u, v, corr[idx].to(dev))
            for plane, (off, n) in zip(want, ((0, ysize), (ysize, csize), (ysize + csize, csize))):
                g = torch.from_numpy(got[off:off + n].copy()).to(dev).view(plane.shape)
                worst = max(worst, int((g.to(torch.int16) - plane.to(torch.int16)).abs().max()))
    return worst


def read_y4m_frame(path: str, clip, index: int, device):
    """Frame ``index`` of the benchmark's own clip, read back from its file."""
    w, h = clip.width, clip.height
    ysize, csize = w * h, (w // 2) * (h // 2)
    with open(path, "rb") as f:
        header = f.readline()
        f.seek(len(header) + index * (6 + ysize + 2 * csize) + 6)
        buf = np.frombuffer(f.read(ysize + 2 * csize), np.uint8)
    y = torch.from_numpy(buf[:ysize].reshape(h, w).copy()).to(device)
    u = torch.from_numpy(buf[ysize:ysize + csize].reshape(h // 2, w // 2).copy()).to(device)
    v = torch.from_numpy(buf[ysize + csize:].reshape(h // 2, w // 2).copy()).to(device)
    return y, u, v
