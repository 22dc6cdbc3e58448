"""Readings that the correctness limits are set from, at a cell's own size:

    python3 codecbench/calibrate.py --workload wacnn.kodak24 --seeds 11,12,13 --seconds 3

For each seed, in one process: one run of the cell with a short window
(the program's numbers: the lower readings), then the control, the
reference at the next lower precision in the program's place, on the same
requests the run's check sampled (the upper readings). Prints one JSON
line a seed, then the largest program reading and the smallest control
reading of each number. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def readings(workload: str, seeds, seconds: float):
    """One dict a seed: the run's verdict, numbers and metrics, and the
    control's numbers on the requests the run sampled."""
    import torch

    from codecbench.harness import cell as harness
    from codecbench.reference import check, weights
    from codecbench.reference import models as ref_models

    device = torch.device("cuda", 0)
    cell = harness.load_cell(workload)
    cfg = cell.config
    pdtype = harness.DTYPES[cfg["codec"]["dtype"]]
    for seed in seeds:
        r = harness.run(cell, seed, seconds, False, device, time.perf_counter())
        line = {"seed": seed, "correct": r["correct"], "failed": r["failed"],
                "attempted": r["attempted"], "program": r["numbers"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "peak": r["device"]["memory_peak_bytes"]}
        t_ctrl = time.perf_counter()
        meta = ref_models.build(cfg["model"], cfg["arch"], pdtype, device="meta")
        state = weights.make_state_dict(
            meta, seed, device, cfg["weights"]["scale_lift"], pdtype,
            cfg["weights"]["gains"])
        pool = cell.traffic.pool(seed, device)
        ref = check.reference_model(cfg["model"], cfg["arch"], state, pdtype, device)
        ctrl = check.control_model(cfg["model"], cfg["arch"], state, pdtype, device)
        worst = None
        for index in r["sampled"]:
            got = check.judge(ref, pool[index], check.control_outputs(
                ctrl, pool[index], device), device)
            worst = got if worst is None else {k: max(worst[k], got[k]) for k in got}
        line["control"] = worst
        line["control_correct"] = check.verdict(worst, cell.limits)
        line["control_s"] = time.perf_counter() - t_ctrl
        del ref, ctrl, state
        torch.cuda.empty_cache()
        yield line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    lines = []
    for line in readings(args.workload, [int(s) for s in args.seeds.split(",")],
                         args.seconds):
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"program_max": {k: max(x["program"][k] for x in lines)
                               for k in lines[0]["program"]}}
    summary["control_min"] = {k: min(x["control"][k] for x in lines)
                              for k in lines[0]["control"]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
