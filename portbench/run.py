"""Run one cell of the benchmark once, on the CUDA card, and print its result.

    python3 portbench/run.py --workload h4b_4k30.render --seed 7 --seconds 30 --trace 0

The cell, its configuration, traffic mix and metrics come from
``BENCHMARK.json`` at the root of the checkout. With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a device trace of the same window. The last
line of standard output is the result as one JSON object; the numbers
compared for ``correct``, each with its limit, are the last lines of
standard error. Exits non-zero, printing no result, without a CUDA card,
or where a JAX package was loaded.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Kernel caches stay in fixed directories inside the checkout; the native
# libav libraries are not built here (the clip is y4m, the sink a FIFO).
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".portbench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".portbench_cache" / "torch_extensions"))
os.environ["VAT_NATIVE_AUTOBUILD"] = "0"
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(plan, out: dict, device: dict) -> dict:
    checks = out["checks"]
    correct = out["failed"] == 0 and all(v <= lim for v, lim in checks.values())
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device}
    trace = out["trace"]
    if trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        line["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from portbench import harness

    plan = harness.cell_plan(harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < plan.chips:
        print(f"portbench: {args.workload} needs {plan.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = harness.run_cell(plan, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    if out["forbidden"] or harness.forbidden_modules():
        names = sorted(set(out["forbidden"]) | set(harness.forbidden_modules()))
        print(f"portbench: the process loaded {', '.join(names)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": plan.chips,
              "memory_peak_bytes": int(out["peak_bytes"])}
    line = result_line(plan, out, device)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
