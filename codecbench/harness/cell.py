"""One run of one cell: set-up, the measured (or traced) window, the
correctness check and the result's line.

The system under test is the port's `Codec` over its model
(`stf_tpu_torch.models.codec`), built once from the configuration's
options. A request compresses a host uint8 batch (the call ends with the
bytes in hand) and then decompresses that stream (the call ends with
x_hat complete on the device, after a synchronise). A request fails when
its fused encode tier did not run or fell back to the per-slice walk,
when its decompress left the fused graph for the per-slice walk, when the
codec warned (a tier's self-check demoted it, an index hash differed), or
when its kernel B1 launches differ from one replay of the phase's graph
or eager analysis (a capture or a fallback inside the window adds
launches).
"""

import gc
import importlib.util
import json
import os
import random
import sys
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.autograd.profiler import record_function

from ..reference import check, weights
from ..reference import models as ref_models
from . import arith
from . import trace as tr
from .traffic import Traffic

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
FORBIDDEN = {"jax", "jaxlib", "flax", "stf_tpu"}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the benchmark must not load,
    compared whole (`stf_tpu_torch` is not `stf_tpu`)."""
    return sorted(FORBIDDEN & {name.split(".")[0] for name in list(sys.modules)})


@dataclass
class Cell:
    name: str
    config: dict
    traffic: Traffic
    end_to_end: List[str]
    per_layer: List[dict]
    limits: dict
    chips: int
    bench_dir: str = BENCH_DIR


def load_cell(name: str, repo: str = REPO) -> Cell:
    """The cell `name` of `repo`'s BENCHMARK.json: its configuration,
    traffic mix, metrics and correctness limits, each found by name."""
    with open(os.path.join(repo, "BENCHMARK.json")) as f:
        bench = json.load(f)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(repo, entry["file"])) as f:
        config = json.load(f)
    bench_dir = os.path.join(repo, "codecbench")
    with open(os.path.join(bench_dir, "limits", f"{name}.json")) as f:
        limits = json.load(f)
    e2e = [m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e)]
    return Cell(name, config, Traffic.load(bench_dir, w["traffic"]), e2e,
                per_layer, limits, int(w["chips"]), bench_dir)


class Program:
    """The port's model and codec, built from the configuration."""

    def __init__(self, config: dict, state: dict, device):
        from stf_tpu_torch import _native
        from stf_tpu_torch.models.codec import Codec
        from stf_tpu_torch.zoo.registry import models

        c = config["codec"]
        with torch.device(device):
            model = models[config["model"]](**config["arch"])
        model.load_state_dict(state)
        self.counts = _native.launch_counts
        self.codec = Codec(
            model, coder=c["coder"], device=device,
            fused_encode=True if c["tier"] == "full" else "split",
            pipeline=c["pipeline"], dtype=DTYPES[c["dtype"]],
            analyze_chunks=c["analyze_chunks"], synth_chunks=c["synth_chunks"])

    def b1_launches(self) -> int:
        return sum(v for k, v in self.counts.items()
                   if k.startswith("window_attention"))


@dataclass(eq=False)
class Done:
    """One request: which pool entry, its clocks, bytes and verdict."""
    index: int
    images: int
    pixels: int
    enc_s: float
    dec_s: float
    y_bytes: int
    nbytes: int
    host_encoded: int
    why: List[str] = field(default_factory=list)
    lost: bool = False
    enc: Optional[dict] = None
    dec: Optional[dict] = None


class NameProbe:
    """The codec's probe outside the traced window: keeps the boundary
    names of a call, synchronises nothing."""

    def __init__(self):
        self.names: List[str] = []

    def __call__(self, name, tensor=None):
        self.names.append(name)


def request(prog: Program, index: int, x: torch.Tensor, expected: Optional[tuple],
            spans: Optional[tr.SpanProbe] = None) -> Done:
    """Compress pool entry `index` (host uint8 x), decompress its stream,
    and judge the request's path (module docstring)."""
    codec = prog.codec
    enc_names, dec_names = NameProbe(), NameProbe()

    def call(phase, names, fn):
        """(fn(probe), its seconds) inside the phase's profiler range and,
        traced, its probe spans; a decompress ends synchronised."""
        probe = names
        if spans is not None:
            probe = lambda name, tensor=None: (names(name), spans(name, tensor))  # noqa: E731
        with record_function(f"codecbench.{phase}"):
            if spans is not None:
                spans.start(phase)
            try:
                t = time.perf_counter()
                out = fn(probe)
                if phase == "decode" and codec.device.type == "cuda":
                    torch.cuda.synchronize()
                return out, time.perf_counter() - t
            finally:
                if spans is not None:
                    spans.stop()

    images, pixels = x.shape[0], x.shape[0] * x.shape[1] * x.shape[2]
    b0 = prog.b1_launches()
    t_start = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            enc, enc_s = call("encode", enc_names,
                              lambda p: codec.compress(x, probe=p))
            b1 = prog.b1_launches()
            dec, dec_s = call("decode", dec_names, lambda p: codec.decompress(
                enc["strings"], enc["shape"], probe=p))
        except (ValueError, RuntimeError, KeyError, IndexError) as e:
            # no answer came: the request is lost, and the run not correct
            return Done(index, images, pixels, time.perf_counter() - t_start,
                        0.0, 0, 0, 0, [f"raised {type(e).__name__}: {e}"],
                        lost=True)
    b2 = prog.b1_launches()
    y_bytes = sum(len(s) for s in enc["strings"][0])
    done = Done(index, images, pixels, enc_s, dec_s, y_bytes,
                y_bytes + sum(len(s) for s in enc["strings"][1]),
                int(enc.get("host_encoded", 0)), enc=enc, dec=dec)
    if "fused_encode_walk" not in enc_names.names or \
            "fused_encode_fallback" in enc_names.names:
        done.why.append("compress left the fused tier")
    if "fused_walk_synth" not in dec_names.names or "z_decode" in dec_names.names:
        done.why.append("decompress left the fused graph")
    done.why += [f"warning: {w.message}" for w in caught]
    if expected is not None and (b1 - b0, b2 - b1) != expected:
        done.why.append(f"B1 launches {b1 - b0} + {b2 - b1}, one replay "
                        f"launches {expected[0]} + {expected[1]}")
    return done


class Reservoir:
    """A uniform sample of k requests from a stream of unknown length,
    its choices drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept = k, random.Random(seed), []

    def offer(self, n: int, item):
        """Offer the n-th item (from 0); returns the item left out, if any."""
        if len(self.kept) < self.k:
            self.kept.append(item)
            return None
        j = self.rng.randrange(n + 1)
        if j < self.k:
            self.kept[j], item = item, self.kept[j]
        return item


def load_readers(per_layer: List[dict], bench_dir: str = BENCH_DIR) -> Dict[str, object]:
    """{metric name: read(ctx)} from <bench_dir>/metrics/<name>.py."""
    out = {}
    for m in per_layer:
        path = os.path.join(bench_dir, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "codecbench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[m["name"]] = mod.read
    return out


@dataclass
class Context:
    """What a per-layer reader reads: the trace, and per phase the images,
    the least times of B1-B3 from their calls' shapes, the transform
    FLOPs' least time, and the lane coder's counters."""
    trace: tr.Trace
    images: Dict[str, int]
    b1_bound_ms: Dict[str, float]
    b2_bound_ms: float
    b3_bound_ms: float
    flop_s: Dict[str, float]
    host_encoded: int
    segments: int


def _shape(x):
    return tuple(x.shape[:3])


def take(request_fn, keep: Reservoir, done: List[Done], pool, expected, prog,
         spans=None):
    """Send the loop's next request (pool entries in turn) and offer it to
    the sample; a request left out of the sample drops its outputs."""
    n = len(done)
    x = pool[n % len(pool)]
    d = request_fn(prog, n % len(pool), x, expected[_shape(x)], spans)
    dropped = None if d.lost else keep.offer(n, d)
    if dropped is not None:
        dropped.enc = dropped.dec = None
    done.append(d)


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, log=lambda s: print(s, file=sys.stderr)) -> dict:
    """One run; returns the result's fields (module docstring of run.py)."""
    cfg, codec_cfg = cell.config, cell.config["codec"]
    pdtype = DTYPES[codec_cfg["dtype"]]
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    meta = ref_models.build(cfg["model"], cfg["arch"], pdtype, device="meta")
    state = weights.make_state_dict(meta, seed, device,
                                    cfg["weights"]["scale_lift"], pdtype,
                                    cfg["weights"]["gains"])
    pool = cell.traffic.pool(seed, device)
    prog = Program(cfg, state, device)
    costs = {s: arith.phase_costs(cfg["model"], cfg["arch"], codec_cfg, s[0],
                                  s[1:], flops=traced)
             for s in {_shape(x) for x in pool}}
    # B1 launches a call: counted where the wrapper launches the kernel,
    # so on the card only
    expected = {s: (len(c["encode"]["b1"]), len(c["decode"]["b1"]))
                if device.type == "cuda" else None for s, c in costs.items()}
    warm = [request(prog, i, x, None) for i, x in enumerate(pool)]
    for d in warm:
        for why in d.why:
            log(f"warm-up request {d.index}: {why}")
    del warm
    keep = Reservoir(cell.traffic.check_requests, seed)
    done: List[Done] = []
    setup_s = None
    context = None
    # set-up's objects leave the collector's generations, so that its
    # passes inside the window stay short and alike from run to run
    gc.collect()
    gc.freeze()
    if not traced:
        setup_s = time.perf_counter() - t_start
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            take(request, keep, done, pool, expected, prog)
    else:
        # the profiler's own start-up, outside the traced window
        tr.profile(lambda: request(prog, 0, pool[0], None))
        spans = tr.SpanProbe()

        def body():
            for _ in range(cell.traffic.trace_requests):
                take(request, keep, done, pool, expected, prog, spans)

        _, events = tr.profile(body)
        context = _context(tr.Trace(events, spans.names), done, pool, costs,
                           codec_cfg, meta)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    # the kept requests' z symbols, read from their streams by the codec's
    # own z decoder (the reference judges them against its own z)
    samples = []
    for d in keep.kept:
        samples.append((d.index, {
            "z_sym": torch.from_numpy(prog.codec.eb_coder.decompress_symbols(
                d.enc["strings"][1], d.enc["shape"])),
            "q_enc": [t.cpu() for t in d.enc["symbols"]],
            "idx_enc": [t.cpu() for t in d.enc["indexes"]],
            "q_dec": [t.cpu() for t in d.dec["symbols"]],
            "x_hat": d.dec["x_hat"].cpu()}))
        d.enc = d.dec = None
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = check.reference_model(cfg["model"], cfg["arch"], state, pdtype, device)
    numbers = None
    for index, outs in samples:
        got = check.judge(ref, pool[index], outs, device)
        numbers = got if numbers is None else {k: max(numbers[k], got[k])
                                              for k in got}
    del ref
    log(f"reference check of {len(samples)} request(s): "
        f"{time.perf_counter() - t_check:.1f} s")
    failed = [d for d in done if d.why]
    for d in failed[:5]:
        log(f"request {d.index} failed: {'; '.join(d.why)}")
    result = {
        "correct": (numbers is not None and check.verdict(numbers, cell.limits)
                    and not any(d.lost for d in done)),
        "attempted": len(done),
        "failed": len(failed),
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
        "numbers": numbers,
        "sampled": [index for index, _ in samples],
    }
    if traced:
        readers = load_readers(cell.per_layer, cell.bench_dir)
        metrics = {}
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        for name, read in readers.items():
            value = read(context)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": units[name]}
        lo, hi = context.trace.window()
        result["device"]["busy_s"] = arith.union_length(
            (t0, t1) for _, t0, t1, _ in context.trace.device if lo <= t0 <= hi) / 1e6
        result["device"]["window_s"] = (hi - lo) / 1e6
        result["metrics"] = metrics
        result["breakdown"] = {"device_ops": context.trace.top_ops(10),
                               "idle_gaps": context.trace.idle_gaps(10)}
    else:
        result["metrics"] = end_to_end(done, setup_s, cell.end_to_end)
    return result


def end_to_end(done: List[Done], setup_s: float, names: List[str]) -> dict:
    """The end-to-end metrics of the measured window. A name's part
    before its first dot says what it measures; a suffix ("single")
    names a class of cells that keeps a bound of its own."""
    images = sum(d.images for d in done)
    values = {
        "encode_ms_per_image": ("ms/image", 1e3 * sum(d.enc_s for d in done) / images),
        "decode_ms_per_image": ("ms/image", 1e3 * sum(d.dec_s for d in done) / images),
        "roundtrip_p95_ms": ("ms", 1e3 * arith.p95([d.enc_s + d.dec_s for d in done])),
        "bpp": ("bits/pixel", 8 * sum(d.nbytes for d in done) / sum(d.pixels for d in done)),
        "setup_s": ("s", setup_s),
    }
    return {n: {"value": values[n.split(".")[0]][1], "unit": values[n.split(".")[0]][0]}
            for n in names}


def _context(trace, done, pool, costs, codec_cfg, meta) -> Context:
    images = {"encode": 0, "decode": 0}
    b1 = {"encode": 0.0, "decode": 0.0}
    flop_s = {"encode": 0.0, "decode": 0.0}
    b2 = b3 = 0.0
    segments = host_encoded = 0
    M, S, P = meta.M, meta.num_slices, codec_cfg["pipeline"]
    for d in done:
        s = _shape(pool[d.index])
        c = costs[s]
        # segments a call codes: a slice of each of the pipeline's
        # sub-batches, or of the whole batch where they do not divide it
        segs = S * (P if P <= s[0] and s[0] % P == 0 else 1)
        symbols = s[0] * -(-s[1] // 16) * -(-s[2] // 16) * M
        for phase in ("encode", "decode"):
            images[phase] += d.images
            b1[phase] += sum(arith.b1_bound_ms(*l) for l in c[phase]["b1"])
            flop_s[phase] += arith.flop_seconds(c[phase]["flops"])
        b2 += arith.lane_decode_bound_ms(symbols, d.y_bytes, segs)
        b3 += arith.lane_encode_bound_ms(symbols, d.y_bytes, segs)
        segments += segs
        host_encoded += d.host_encoded
    return Context(trace, images, b1, b2, b3, flop_s, host_encoded, segments)
