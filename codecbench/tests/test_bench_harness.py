"""The harness is driven by data: a configuration, a traffic mix, a
per-layer metric and a reference architecture added as files are found
by name; BENCHMARK.json keeps to the allowed names and units; the runner
loads no JAX."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from codecbench.harness import cell as harness
from codecbench.reference import models as ref_models

from _tiny import CONFIGS

REPO = harness.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _copy(tmp_path, ignore=("__pycache__", "tests")):
    """BENCHMARK.json and codecbench/ copied into tmp_path; returns the
    copy of codecbench/."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "codecbench"), tmp_path / "codecbench",
                    ignore=shutil.ignore_patterns(*ignore))
    return tmp_path / "codecbench"


def test_added_config_mix_and_metric_are_found_by_name(tmp_path):
    bench_dir = _copy(tmp_path)
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(CONFIGS["cnn"]))
    (bench_dir / "traffic" / "pairs.json").write_text(json.dumps(
        {"loop": "closed", "batch": 2, "sizes": [[64, 64, 4]],
         "trace_requests": 2, "check_requests": 1}))
    (bench_dir / "metrics" / "images_traced.py").write_text(
        "def read(ctx):\n    return ctx.images['encode']\n")
    (bench_dir / "limits" / "tiny.pairs.json").write_text(json.dumps(
        {"symbol_mismatch": 0}))
    bench = _bench()
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "codecbench/configs/tiny.json",
                             "reduced": [], "why": "a test's"})
    bench["workloads"].append({"name": "tiny.pairs", "config": "tiny",
                               "traffic": "pairs", "chips": 1, "why": "a test's"})
    bench["per_layer"].append({"name": "images_traced", "unit": "images",
                               "better": "higher", "source": "program_counter",
                               "layer": "codec host stages",
                               "moves": "encode_ms_per_image",
                               "workloads": ["tiny.pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("tiny.pairs", repo=str(tmp_path))
    assert cell.config == CONFIGS["cnn"]
    assert cell.traffic.batch == 2 and cell.traffic.sizes == [[64, 64, 4]]
    assert [m["name"] for m in cell.per_layer] == ["images_traced"]
    assert cell.limits == {"symbol_mismatch": 0}
    assert "roundtrip_p95_ms" not in cell.end_to_end
    readers = harness.load_readers(cell.per_layer, cell.bench_dir)
    assert readers["images_traced"](harness.Context(
        None, {"encode": 4, "decode": 4}, {}, 0, 0, {}, 0, 0)) == 4
    pool = cell.traffic.pool(3, "cpu")
    assert [tuple(x.shape) for x in pool] == [(2, 64, 64, 3)] * 2
    # an existing cell still finds its own files
    assert harness.load_cell("wacnn.kodak24", repo=str(tmp_path)).config["model"] == "cnn"


# Run inside a copy of codecbench/ that holds one more architecture,
# `cnn_copy` (arch/cnn.py under a new name), and its tests/tiny file: the
# copy's own code builds it, draws its weights, counts its phase costs and
# judges a run of it and of its control. The program's registry gets the
# name as an alias of its WACNN, as a registry entry of the program's own
# would give it.
ROOM = """
import os
from stf_tpu_torch.zoo.registry import models
models["cnn_copy"] = models["cnn"]
import torch
torch.set_num_threads(2)
import _tiny
from codecbench.harness import arith, cell as harness
from codecbench.reference import check, weights
from codecbench.reference import models as ref_models
bench = os.path.abspath("codecbench")
assert ref_models.ARCH_DIR == os.path.join(bench, "reference", "arch")
assert _tiny.TINY_DIR == os.path.join(bench, "tests", "tiny")
assert _tiny.MODELS == sorted(_tiny.MODELS) and "cnn_copy" in _tiny.MODELS
cfg = _tiny.CONFIGS["cnn_copy"]
dtype = harness.DTYPES[cfg["codec"]["dtype"]]
ref = ref_models.build("cnn_copy", cfg["arch"], dtype, device="meta")
assert type(ref).__name__ == "WACNN"
state = weights.make_state_dict(ref, 3, "cpu", cfg["weights"]["scale_lift"],
                                dtype, cfg["weights"]["gains"])
same = weights.make_state_dict(ref_models.build("cnn", cfg["arch"], dtype, device="meta"),
                               3, "cpu", cfg["weights"]["scale_lift"], dtype,
                               cfg["weights"]["gains"])
assert all(torch.equal(state[k], same[k]) for k in same) and state.keys() == same.keys()
costs = arith.phase_costs("cnn_copy", cfg["arch"], cfg["codec"], 2, (64, 128))
assert costs == arith.phase_costs("cnn", cfg["arch"], cfg["codec"], 2, (64, 128))
assert costs["encode"]["b1"] and costs["decode"]["flops"]["float32"] > 0
x = _tiny.cell("cnn_copy").traffic.pool(3, "cpu")[0]
judged = check.reference_model("cnn_copy", cfg["arch"], state, dtype, "cpu")
ctrl = check.control_model("cnn_copy", cfg["arch"], state, dtype, "cpu")
got = check.judge(judged, x, check.control_outputs(ctrl, x, "cpu"), "cpu")
assert not check.verdict(got, _tiny.limits("cnn_copy")), got
r = _tiny.run("cnn_copy")
assert r["correct"] and r["failed"] == 0, r["numbers"]
print("ROOM OK")
"""


def test_an_architecture_added_as_files_is_built_weighted_counted_and_judged(tmp_path):
    bench_dir = _copy(tmp_path, ignore=("__pycache__",))
    arch = bench_dir / "reference" / "arch"
    (arch / "cnn_copy.py").write_text((arch / "cnn.py").read_text())
    tiny = bench_dir / "tests" / "tiny"
    (tiny / "cnn_copy.json").write_text((tiny / "cnn.json").read_text().replace(
        '"model": "cnn"', '"model": "cnn_copy"'))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(bench_dir / "tests"), REPO]))
    out = subprocess.run([sys.executable, "-c", ROOM], capture_output=True,
                         text=True, cwd=str(tmp_path), env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ROOM OK" in out.stdout


def test_a_missing_architecture_file_is_named():
    with pytest.raises(KeyError, match=re.escape(
            os.path.join(ref_models.ARCH_DIR, "no_such_model.py"))):
        ref_models.build("no_such_model", {}, device="meta")
    for bad in ("../cnn", "CNN", "cnn.py", ""):
        with pytest.raises(ValueError, match="model name"):
            ref_models.build(bad, {}, device="meta")


def test_benchmark_names_and_units_keep_to_the_allowed_characters():
    bench = _bench()
    metrics = bench["end_to_end"] + bench["per_layer"]
    for entry in bench["configs"] + bench["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    names = [e["name"] for e in metrics]
    assert len(names) == len(set(names))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(REPO, "codecbench", "metrics", m["name"] + ".py"))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(REPO, "codecbench", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(REPO, "codecbench", "limits", w["name"] + ".json"))


def test_the_runner_loads_neither_jax_nor_the_jax_package():
    """A run's modules (the harness, the program on the CPU, the
    reference), compared by whole top-level name."""
    code = ("import sys; sys.path.insert(0, 'codecbench/tests'); import _tiny; "
            "_tiny.run('cnn', seconds=0.2); "
            "from codecbench.harness import cell; "
            "print('FOUND', cell.forbidden_modules(), "
            "'stf_tpu_torch' in {m.split('.')[0] for m in sys.modules})")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND [] True" in out.stdout


@pytest.mark.parametrize("only_benchmark", [False, True])
def test_a_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path, only_benchmark):
    cwd = REPO
    if only_benchmark:  # a checkout that holds only the benchmark's files
        shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
        shutil.copytree(os.path.join(REPO, "codecbench"), tmp_path / "codecbench")
        cwd = str(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "codecbench/run.py", "--workload",
                          "wacnn.kodak24", "--seed", str(2 ** 33), "--seconds", "1"],
                         capture_output=True, text=True, cwd=cwd, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
