"""The port's benchmark: one run of one cell.

    python3 codecbench/run.py --workload wacnn.kodak24 --seed 7 --seconds 20 --trace 0

Run from the root of a checkout on a machine with the card(s) the cell
asks for. It builds the seeded weights and images, sets up the port's
codec (`stf_tpu_torch`), warms up every shape the cell's traffic uses,
measures for --seconds (--trace 0: the end-to-end metrics) or traces a
fixed number of requests (--trace 1: the per-layer metrics), checks the
outputs against the plain reference, and prints one JSON object as the
last line of standard output:

    {"correct", "attempted", "failed", "metrics", "device",
     ["breakdown",] "checks"}

"checks" holds each number compared with its limit; the same lines end
standard error. Without a CUDA card (or with fewer than the cell asks
for) it exits with code 3 and prints no result; if a module of JAX or of
the JAX package is loaded once the window has closed, with code 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from codecbench.harness import cell as harness

    bench = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < bench.chips:
        print(f"codecbench: the cell needs {bench.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    result = harness.run(bench, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"codecbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    numbers = result.pop("numbers")
    result.pop("sampled")
    result["checks"] = {k: {"value": numbers[k] if numbers else None, "limit": v}
                        for k, v in bench.limits.items()}
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
