"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric added as files are found by name; BENCHMARK.json keeps
to the allowed names and units; the runner loads no JAX."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from codecbench.harness import cell as harness

from _tiny import CONFIGS

REPO = harness.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_added_config_mix_and_metric_are_found_by_name(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "codecbench"), tmp_path / "codecbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench_dir = tmp_path / "codecbench"
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
