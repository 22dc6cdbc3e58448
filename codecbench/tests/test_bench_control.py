"""The comparison that decides `correct`: a sound run passes, the control
(the reference one precision lower in the program's place) and each
planted fault of a served answer fail. At a small size on the CPU, held
to the cells' own limits."""

import pytest
import torch

from codecbench.harness import cell as harness
from codecbench.reference import check, weights
from codecbench.reference import models as ref_models

import _tiny

torch.set_num_threads(2)


@pytest.mark.parametrize("model", _tiny.MODELS)
def test_a_sound_run_is_correct(model):
    r = _tiny.run(model)
    assert r["correct"] and r["failed"] == 0, r["numbers"]


@pytest.mark.parametrize("model", _tiny.MODELS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(model, seed):
    cfg = _tiny.CONFIGS[model]
    dtype = harness.DTYPES[cfg["codec"]["dtype"]]
    meta = ref_models.build(model, cfg["arch"], dtype, device="meta")
    state = weights.make_state_dict(meta, seed, "cpu", cfg["weights"]["scale_lift"],
                                    dtype, cfg["weights"]["gains"])
    x = _tiny.cell(model).traffic.pool(seed, "cpu")[0]
    ref = check.reference_model(model, cfg["arch"], state, dtype, "cpu")
    ctrl = check.control_model(model, cfg["arch"], state, dtype, "cpu")
    got = check.judge(ref, x, check.control_outputs(ctrl, x, "cpu"), "cpu")
    assert not check.verdict(got, _tiny.limits(model)), got
    # the reference in the program's place, at its own precision, passes
    got = check.judge(ref, x, check.control_outputs(ref, x, "cpu"), "cpu")
    assert check.verdict(got, _tiny.limits(model)), got


def _decoded_symbol_altered(monkeypatch):
    from stf_tpu_torch.ans import lane_coder as lc
    real = lc.lane_decode

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out.view(-1)[7] += 1
        return out
    monkeypatch.setattr(lc, "lane_decode", altered)


def _xhat_altered(monkeypatch):
    from stf_tpu_torch.models.codec import Codec
    real = Codec._synthesize

    def altered(self, y_hats):
        out = real(self, y_hats).clone()
        out.view(-1)[11] = 1.0 - out.view(-1)[11]
        return out
    monkeypatch.setattr(Codec, "_synthesize", altered)


def _index_altered(monkeypatch):
    from stf_tpu_torch.models import base
    real = base.gaussian_build_indexes

    def altered(scales, table):
        return (real(scales, table) + 1).clamp_max(len(table) - 1)
    monkeypatch.setattr(base, "gaussian_build_indexes", altered)


def _z_symbol_altered(monkeypatch):
    from stf_tpu_torch.entropy import EntropyBottleneckCoder
    real = EntropyBottleneckCoder.compress_symbols

    def altered(self, symbols):
        symbols = symbols.copy()
        symbols.reshape(-1)[3] += 2
        return real(self, symbols)
    monkeypatch.setattr(EntropyBottleneckCoder, "compress_symbols", altered)


@pytest.mark.parametrize("fault", [_decoded_symbol_altered, _xhat_altered,
                                   _index_altered, _z_symbol_altered])
@pytest.mark.parametrize("model", _tiny.MODELS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch, fault, model):
    fault(monkeypatch)
    r = _tiny.run(model, seconds=0.5)
    assert not r["correct"], r["numbers"]
