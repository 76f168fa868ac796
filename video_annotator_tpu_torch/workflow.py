"""Match-processing workflow: the native analogue of ``concat.sh``.

Port of ``video_annotator_tpu/workflow.py``. The reference's workflow
over a recorded match (``concat.sh:341-360``): ``stabilise`` (motion
analysis of each chapter in parallel, ``:197-219``), ``join``
(``:192-195``), ``tag`` (set timecodes and scores into a metadata file,
``:136-190``), ``split`` (one render per set, claimed through lockfiles so
that concurrent workers never collide and a crashed run resumes,
``:221-283``) and ``encode`` (the final encode, ``:285-335``).

The metadata is a JSON file beside the footage, byte for byte the JAX
package's. ``stabilise`` runs the port's analyse on ``device`` (a CUDA
card unless the caller names the CPU); ``split`` renders each set in a
child process of this package's CLI (``python -m
video_annotator_tpu_torch render``), which runs on the card; ``tag`` and
``encode`` are host IO.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from video_annotator_tpu_torch.io.gopro import find_source_segments


@dataclasses.dataclass
class MatchSet:
    """One set of a match: its trim range and score."""

    start: float  # seconds into the joined video
    end: float
    score: str = ""  # for example "21-19"


@dataclasses.dataclass
class MatchMeta:
    code: str
    sets: List[MatchSet]

    @staticmethod
    def path(code: str, directory: str = ".") -> str:
        return os.path.join(directory, f"match_{code}.json")

    def save(self, directory: str = "."):
        with open(self.path(self.code, directory), "w") as f:
            json.dump({"code": self.code, "sets": [dataclasses.asdict(s) for s in self.sets]},
                      f, indent=2)

    @staticmethod
    def load(code: str, directory: str = ".") -> "MatchMeta":
        with open(MatchMeta.path(code, directory)) as f:
            d = json.load(f)
        return MatchMeta(code=d["code"], sets=[MatchSet(**s) for s in d["sets"]])


def tag(code: str, directory: str = ".", sets_json: Optional[str] = None):
    """Capture the sets' timecodes and scores (``concat.sh:136-190``):
    prompts by default; ``sets_json`` takes a JSON array of ``{"start": s,
    "end": s, "score": "21-19"}`` for scripted use."""
    if sets_json:
        sets = [MatchSet(**s) for s in json.loads(sets_json)]
    else:
        sets = []
        print("Enter sets (empty start to finish):")
        while True:
            start = input(f"set {len(sets) + 1} start (seconds): ").strip()
            if not start:
                break
            end = input("  end (seconds): ").strip()
            score = input("  score: ").strip()
            sets.append(MatchSet(float(start), float(end), score))
    MatchMeta(code, sets).save(directory)
    print(f"wrote {MatchMeta.path(code, directory)} ({len(sets)} sets)")


def _claim(lockfile: str) -> bool:
    """Lockfile work claiming (``concat.sh:260-273``): the first worker to
    create the lock exclusively owns the job."""
    try:
        fd = os.open(lockfile, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    os.write(fd, str(os.getpid()).encode())
    os.close(fd)
    return True


def stabilise(code: str, directory: str = ".", concurrency: int = 2, device="cuda"):
    """Motion analysis of every chapter in parallel (``concat.sh:197-219``:
    vidstabdetect over the chapters with xargs -P) on ``device``. The
    trajectories are the ``.trf`` files' analogue, claimed through
    lockfiles and marked ``.complete``, so a second run skips them."""
    from video_annotator_tpu_torch.pipeline.render import RenderOptions, analyse
    from video_annotator_tpu_torch.pipeline.trajectory import trajectory_path

    segments = find_source_segments(code, directory)

    def work(seg: str):
        tpath = trajectory_path(seg)
        done = tpath + ".complete"
        lock = tpath + ".lock"
        if os.path.exists(done):
            return f"{seg}: already analysed"
        if not _claim(lock):
            return f"{seg}: claimed by another worker"
        try:
            traj = analyse(seg, RenderOptions(), device=device)
            traj.save(tpath)
            open(done, "w").close()
            return f"{seg}: {traj.num_frames} frames analysed"
        finally:
            os.unlink(lock)

    with ThreadPoolExecutor(max_workers=concurrency) as ex:
        for msg in ex.map(work, segments):
            print(msg)


def split(code: str, directory: str = ".", concurrency: int = 1,
          render_args: Optional[List[str]] = None):
    """Render each tagged set to its own file (``concat.sh:221-283``).

    Each set is claimed with a lockfile and marked ``.complete``, so a
    crashed or concurrent run can be started again. The renders are child
    processes of this package's CLI (the reference's process-level
    parallelism); keep ``concurrency=1`` with one card."""
    meta = MatchMeta.load(code, directory)
    joined = os.path.join(directory, f"match_{code}.mp4")
    if not os.path.exists(joined):
        alt = os.path.join(directory, f"match_{code}.y4m")
        if not os.path.exists(alt):
            raise FileNotFoundError(
                f"joined video not found: {joined} (run 'join {code}' first)")
        joined = alt
    ext = os.path.splitext(joined)[1]

    def work(i_set):
        i, s = i_set
        out = os.path.join(directory, f"match_{code}_set{i + 1}{ext}")
        done = out + ".complete"
        lock = out + ".lock"
        if os.path.exists(done):
            return f"set {i + 1}: already rendered"
        if not _claim(lock):
            return f"set {i + 1}: claimed by another worker"
        try:
            cmd = [sys.executable, "-m", "video_annotator_tpu_torch", "render",
                   joined, out, "-s", str(s.start), "-e", str(s.end)] + (render_args or [])
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                return f"set {i + 1}: FAILED\n{r.stderr[-500:]}"
            open(done, "w").close()
            return f"set {i + 1}: rendered to {out}"
        finally:
            os.unlink(lock)

    with ThreadPoolExecutor(max_workers=max(concurrency, 1)) as ex:
        for msg in ex.map(work, enumerate(meta.sets)):
            print(msg)


def encode(code: str, directory: str = ".", encoder: Optional[str] = None):
    """Encode the sets' renders to their final form (``concat.sh:285-335``'s
    NVENC/VAAPI stage): libx264 at QP 19 where the native writer is built,
    OpenCV otherwise."""
    from video_annotator_tpu_torch.io.video import default_encoder, open_reader, open_writer

    encoder = encoder or default_encoder()
    meta = MatchMeta.load(code, directory)
    for i in range(len(meta.sets)):
        src = None
        for ext in (".y4m", ".mp4"):
            cand = os.path.join(directory, f"match_{code}_set{i + 1}{ext}")
            if os.path.exists(cand):
                src = cand
                break
        if src is None:
            print(f"set {i + 1}: no render found, skipping")
            continue
        out = os.path.join(directory, f"match_{code}_set{i + 1}_final.mp4")
        done = out + ".complete"
        if os.path.exists(done):
            print(f"set {i + 1}: already encoded")
            continue
        reader = open_reader(src)
        writer = open_writer(out, reader.meta, encoder=encoder, copy_streams_from=src)
        n = 0
        for planes in reader:
            writer.write(planes)
            n += 1
        writer.close()
        reader.close()
        open(done, "w").close()
        print(f"set {i + 1}: encoded {n} frames to {out}")
