"""Small cells of every reference architecture for the CPU tests: the
configurations' structure at a size a test run holds (64x64 and 64x128
images, narrow channels, 4 slices), run through the harness on the CPU,
where the program's kernels run their plain versions and its graphs run
eagerly.

Each model is a file `tiny/<model>.json`: its `model`, `arch`, `codec`
and `weights`, as a configuration holds them, and `limits`, the cell
whose correctness limits it is held to. A file added there puts its model
into every test parametrised over `MODELS`."""

import json
import os
import time

import torch

from codecbench.harness import cell as harness
from codecbench.harness.traffic import Traffic

BENCH_DIR = harness.BENCH_DIR
TINY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")
MODELS = sorted(f[:-len(".json")] for f in os.listdir(TINY_DIR) if f.endswith(".json"))


def _load(model):
    with open(os.path.join(TINY_DIR, model + ".json")) as f:
        return json.load(f)


_TINY = {m: _load(m) for m in MODELS}
CONFIGS = {m: {k: v for k, v in t.items() if k != "limits"} for m, t in _TINY.items()}
LIMITS = {m: t["limits"] for m, t in _TINY.items()}


def limits(model):
    with open(os.path.join(BENCH_DIR, "limits", LIMITS[model] + ".json")) as f:
        return json.load(f)


def cell(model, per_layer=()):
    traffic = Traffic("tiny", "closed", 2, [[64, 64, 4], [64, 128, 2]], 3, 2)
    return harness.Cell("tiny." + model, CONFIGS[model], traffic,
                        ["encode_ms_per_image", "decode_ms_per_image",
                         "roundtrip_p95_ms", "bpp", "setup_s"],
                        list(per_layer), limits(model), 1)


def run(model, seed=2 ** 33 + 7, seconds=1.0, traced=False, per_layer=()):
    return harness.run(cell(model, per_layer), seed, seconds, traced,
                       torch.device("cpu"), time.perf_counter(), log=lambda s: None)
