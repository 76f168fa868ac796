"""Provenance stamps for the port's measurement JSON.

Port of ``benchmarks/provenance.py``: every tool of this package stamps
what it writes with the checkout's git SHA (``-dirty`` with uncommitted
changes), the capture time, and what ran it. Where the JAX package wrote
its jax backend, the port writes the torch and CUDA versions and, as
``backend``, the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them, or
``"cpu"`` for a run of the plain versions on the CPU.
"""

from __future__ import annotations

import subprocess
import time
from pathlib import Path

import torch


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def git_sha() -> str:
    """The checkout's short SHA, ``-dirty`` with uncommitted changes;
    ``unknown`` outside a git checkout."""
    here = Path(__file__).resolve().parent
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=here,
                             capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        if out.returncode != 0 or not sha:
            return "unknown"
        dirty = subprocess.run(["git", "status", "--porcelain"], cwd=here,
                               capture_output=True, text=True, timeout=10)
        return sha + ("-dirty" if dirty.returncode == 0 and dirty.stdout.strip() else "")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def stamp(record: dict, device="cuda") -> dict:
    """Add ``git_sha``, ``captured_at_utc``, ``torch``, ``cuda`` and
    ``backend`` (the card's label on a CUDA ``device``, else ``"cpu"``)
    to ``record`` in place and return it."""
    record["git_sha"] = git_sha()
    record["captured_at_utc"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    record["torch"] = torch.__version__
    record["cuda"] = torch.version.cuda
    record["backend"] = card_label() if torch.device(device).type == "cuda" else "cpu"
    return record
