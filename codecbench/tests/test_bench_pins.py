"""What the reference must keep while its code moves: the seeded weights
and the phase costs of the full-width configurations, against the values
in `pins.json`, read from the reference as it stood before each
architecture became a file of its own (`reference/arch/<model>.py`).

The weights' digest covers every parameter's name, shape and float32
bytes, drawn on the CPU at one seed with the configuration's own
`scale_lift`, gains and bfloat16 rounding; the costs are the FLOPs by
dtype and B1's launches of `arith.phase_costs` at the cells' two image
layouts."""

import hashlib
import json
import os

import pytest
import torch

from codecbench.harness import arith
from codecbench.harness import cell as harness
from codecbench.reference import models as ref_models
from codecbench.reference import weights

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "pins.json")) as f:
    PINS = json.load(f)


def _config(name):
    with open(os.path.join(harness.BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


def _digest(state):
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(str(tuple(state[k].shape)).encode())
        h.update(state[k].contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINS["configs"]))
def test_seeded_weights_keep_their_digest(name):
    cfg, pin = _config(name), PINS["configs"][name]
    dtype = harness.DTYPES[cfg["codec"]["dtype"]]
    meta = ref_models.build(cfg["model"], cfg["arch"], dtype, device="meta")
    state = weights.make_state_dict(meta, PINS["seed"], "cpu",
                                    cfg["weights"]["scale_lift"], dtype,
                                    cfg["weights"]["gains"])
    assert sum(v.numel() for v in state.values()) == pin["parameters"]
    assert _digest(state) == pin["state_sha256"]


@pytest.mark.parametrize("shape", [tuple(s) for s in PINS["shapes"]])
@pytest.mark.parametrize("name", sorted(PINS["configs"]))
@torch.no_grad()
def test_phase_costs_keep_their_flops_and_launches(name, shape):
    cfg = _config(name)
    want = PINS["configs"][name]["costs"]["x".join(map(str, shape))]
    got = arith.phase_costs(cfg["model"], cfg["arch"], cfg["codec"], shape[0], shape[1:])
    for phase in ("encode", "decode"):
        assert got[phase]["flops"] == want[phase]["flops"], phase
        assert [[list(s), ws, nh, shifted, dt] for s, ws, nh, shifted, dt
                in got[phase]["b1"]] == want[phase]["b1"], phase
