"""The readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/readings.py --workload h4b_4k30.render --seeds 12 --control-seeds 3 \\
        --out chiprun_out/readings.json

For each seed, in one process: one job of the cell's own traffic at its own
size through the harness (set-up, one job in the window, the check), and
the numbers the check compares: the lower readings. Then the control on
``--control-seeds`` seeds: the reference put in the program's place and
computed in bfloat16, the precision below the configuration's float32
(the sampled frames of a job warped in bfloat16, the trajectory computed
in bfloat16), held to the same comparison: the upper readings. The
benchmark's own runs do not run this.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
os.environ["VAT_NATIVE_AUTOBUILD"] = "0"
sys.path.insert(0, str(ROOT))


def control_readings(plan, seed: int, device: str) -> dict:
    """The check's numbers for the bfloat16 reference in the program's
    place, on the cell's clip: trajectories and sampled frames."""
    import numpy as np
    import torch

    from portbench import generator, harness, reference

    clip = generator.Clip(plan.cfg, seed)
    out = {}
    if plan.mix["analyses"]:
        expect = reference.expected_rotations(clip.rotvecs)
        err = reference.angle_errors_deg(reference.truth_params(clip.rotvecs, torch.bfloat16),
                                         expect)
        out["traj_rms_deg"] = float(np.sqrt(np.mean(err ** 2)))
        out["traj_max_deg"] = float(err.max())
    if plan.mix["frames_out"]:
        warp = reference.Warp(clip.camera, float(plan.cfg["stabilise_buffer_percent"]))
        corr = reference.corrections(reference.truth_params(clip.rotvecs),
                                     int(plan.cfg["stabilise_radius"]))
        idx = sorted(harness.sample_frames(seed, 0, clip.frames,
                                           max(plan.mix["sample_frames_per_job"], 1)))
        worst = 0
        frames = {t: (y, u, v) for t, y, u, v in clip.render(device) if t in idx}
        for t in idx:
            rot = corr[t].to(device)
            want = warp.frame(*frames[t], rot)
            got = warp.frame(*frames[t], rot, dtype=torch.bfloat16)
            worst = max(worst, max(int((g.to(torch.int16) - w.to(torch.int16)).abs().max())
                                   for g, w in zip(got, want)))
        out["frame_max_diff"] = worst
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=4_100_000_000)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    plan = harness.cell_plan(harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + i
        t = time.monotonic()
        res = harness.run_cell(plan, seed, 0.0, False, "cuda", t, warmup=(i == 0))
        rows.append({"seed": seed, "checks": {k: v for k, (v, _) in res["checks"].items()},
                     "metrics": res["metrics"], "seconds": time.monotonic() - t})
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    controls = []
    for i in range(args.control_seeds):
        seed = args.first_seed + 1000 + i
        controls.append({"seed": seed, "checks": control_readings(plan, seed, "cuda")})
        print(json.dumps(controls[-1]), file=sys.stderr, flush=True)
    names = sorted({k for r in rows for k in r["checks"]})
    summary = {k: {"lower": max(r["checks"][k] for r in rows),
                   "upper": min((c["checks"][k] for c in controls if k in c["checks"]),
                                default=None)} for k in names}
    report = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
              "program": rows, "control": controls, "summary": summary,
              "seconds": time.monotonic() - T_START}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
