"""The collector process reads a FIFO of y4m frames."""

import json
import os
import subprocess
import sys
import time

import numpy as np

from portbench import harness


def test_collector_counts_stamps_and_keeps(tmp_path):
    w, h, n = 64, 48, 7
    fifo = tmp_path / "out.y4m"
    os.mkfifo(fifo)
    proc = subprocess.Popen([sys.executable, str(harness.HERE / "collector.py")],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    proc.stdin.write((json.dumps({"fifo": str(fifo), "sample": [2, 6]}) + "\n").encode())
    proc.stdin.flush()
    frames = [np.full(w * h * 3 // 2, t, np.uint8) for t in range(n)]
    t0 = time.monotonic()
    with open(fifo, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420jpeg\n".encode())
        for fr in frames:
            f.write(b"FRAME\n" + fr.tobytes())
    proc.stdin.write(b'{"stop": true}\n')
    proc.stdin.flush()
    jobs = json.loads(proc.stdout.readline())
    kept = [proc.stdout.read(w * h * 3 // 2) for _ in range(2)]
    assert proc.wait() == 0
    (job,) = jobs
    assert (job["frames"], job["width"], job["height"], job["bad"]) == (n, w, h, 0)
    assert job["kept"] == [2, 6]
    assert t0 <= job["t_first"] <= job["t_last"] <= time.monotonic()
    assert [np.frombuffer(k, np.uint8)[0] for k in kept] == [2, 6]


def test_collector_flags_a_cut_frame(tmp_path):
    fifo = tmp_path / "out.y4m"
    os.mkfifo(fifo)
    proc = subprocess.Popen([sys.executable, str(harness.HERE / "collector.py")],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    proc.stdin.write((json.dumps({"fifo": str(fifo), "sample": []}) + "\n").encode())
    proc.stdin.flush()
    with open(fifo, "wb") as f:
        f.write(b"YUV4MPEG2 W8 H8 F30:1 Ip A1:1 C420jpeg\nFRAME\n" + bytes(96) + b"FRAME\n"
                + bytes(10))
    proc.stdin.write(b'{"stop": true}\n')
    proc.stdin.flush()
    (job,) = json.loads(proc.stdout.readline())
    proc.wait()
    assert (job["frames"], job["bad"]) == (1, 1)
