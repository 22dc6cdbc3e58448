"""Small cells of both models for the CPU tests: the configurations'
structure at a size a test run holds (64x64 and 64x128 images, narrow
channels, 4 slices), run through the harness on the CPU, where the
program's kernels run their plain versions and its graphs run eagerly."""

import json
import os
import time

import torch

from codecbench.harness import cell as harness
from codecbench.harness.traffic import Traffic

BENCH_DIR = harness.BENCH_DIR
CONFIGS = {
    "cnn": {"model": "cnn",
            "arch": {"N": 16, "M": 32, "num_slices": 4, "max_support_slices": 2},
            "codec": {"coder": "lane", "dtype": "bfloat16", "tier": "full",
                      "pipeline": 2, "analyze_chunks": 1, "synth_chunks": 1},
            "weights": {"scale_lift": 1.0, "gains": {"g_a.7": 12.5, "h_a.8": 100.0}}},
    "stf": {"model": "stf",
            "arch": {"embed_dim": 16, "depths": [1, 1, 2, 1],
                     "num_heads": [1, 2, 4, 8], "num_slices": 4},
            "codec": {"coder": "lane", "dtype": "bfloat16", "tier": "split",
                      "pipeline": 1, "analyze_chunks": 2, "synth_chunks": 2},
            "weights": {"scale_lift": 1.0, "gains": {"h_a.8": 100.0}}},
}
LIMITS = {"cnn": "wacnn.kodak24", "stf": "stf.kodak24"}


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
