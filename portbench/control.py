"""Readings of the check's numbers for its limits: the control and the
planted faults at a cell's own size, one set-up a seed, in one process.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 5 --mode tf32|highest|high|bf16|sound|<fault>

`tf32`: the reference's scorer of the configuration's kind
(`kinds/<model>.py`) computed in TF32, put in the program's place; `high`,
`bf16`: the program's own lower -gmmprec paths; `sound`: the program as
the configuration states it; a fault of `faults.py`: that fault planted.
Prints one JSON line a seed: the check's numbers and the run's `correct`.
The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(HERE, ".cache", sub)
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch import nn  # noqa: E402

from portbench import faults, harness  # noqa: E402
from portbench.reference import model as ref_model  # noqa: E402
from portbench.reference import scores as ref_scores  # noqa: E402


class ControlScorer(nn.Module):
    """The reference's scorer in a lower precision, in the program's place."""

    def __init__(self, dec, kind: str, precision: str):
        super().__init__()
        m = ref_model.read_model(dec.config["hmm"], dec.config["lm"],
                                 dec.config["dict"], kind)
        self.ref = ref_scores.reference_scorer(m, str(dec.device), precision)

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats.reshape(-1, feats.shape[-1])
        with torch.no_grad():
            out = self.ref(x).float()
        return out.reshape(*feats.shape[:-1], out.shape[-1])

    forward = score


def options(mode: str) -> dict:
    if mode == "tf32":
        return {"scorer": lambda dec, kind: ControlScorer(dec, kind, "tf32")}
    if mode in ("highest", "high", "bf16"):
        return {"decoder_args": {"gmmprec": mode}}
    if mode == "sound":
        return {}
    return {"patch": faults.FAULTS[mode]}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--mode", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    bench = os.path.join(ROOT, "BENCHMARK.json")
    rc = 0
    for seed in (int(s) for s in a.seeds.split(",")):
        try:
            r = harness.run_cell(bench, a.workload, seed, a.seconds, False,
                                 device=a.device, **options(a.mode))
            out = {"workload": a.workload, "mode": a.mode, "seed": seed,
                   "correct": r.line["correct"], "numbers": r.numbers,
                   "attempted": r.line["attempted"],
                   "failed": r.line["failed"]}
        except Exception as e:
            traceback.print_exc()
            out = {"workload": a.workload, "mode": a.mode, "seed": seed,
                   "error": f"{type(e).__name__}: {e}"}
            rc = 1
        print(json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
