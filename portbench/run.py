"""The benchmark of cmusphinx_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 portbench/run.py --list

from the root of a checkout.  Prints progress and the checked numbers on
standard error, and as the last line of standard output one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and last `check` (each compared number with its limit).
Without an NVIDIA card it exits 2 and prints no result; it never falls
back to the CPU.  `--list` prints every cell and the files the harness
resolves for it.
"""

import argparse
import json
import os
import sys
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Build and kernel caches at fixed places inside the checkout.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(HERE, ".cache", sub)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--list", action="store_true")
    a = p.parse_args(argv)
    bench = os.path.join(ROOT, "BENCHMARK.json")
    from portbench import harness
    if a.list:
        print("\n".join(harness.listing(bench)))
        return 0
    if not a.workload:
        p.error("--workload is required")
    import torch
    chips = harness.find(harness.load_spec(bench), "workloads",
                         a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        res = harness.run_cell(bench, a.workload, a.seed, a.seconds,
                               bool(a.trace))
    except Exception:
        traceback.print_exc()
        return 1
    for k, c in res.checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res.line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
