"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, and its entry points default to the card."""

import os
import re
import subprocess
import sys

import pytest

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "stf_tpu_torch")


def test_import_pulls_in_no_jax():
    """Importing the package and every submodule loads no jax, flax or
    stf_tpu module (run in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import stf_tpu_torch\n"
        "for m in pkgutil.walk_packages(stf_tpu_torch.__path__, 'stf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'stf_tpu'))\n"
        "print(len([k for k in sys.modules if k.startswith('stf_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every submodule was imported


def test_sources_name_no_jax():
    """No source file of the port imports jax/flax or the JAX package."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|stf_tpu)(\.|\s|$)", re.M
    )
    offenders = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    if pattern.search(f.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders


def test_codec_defaults_to_cuda():
    """Codec() without a device targets CUDA and raises where there is
    none; it never falls back to the CPU."""
    import torch

    from stf_tpu_torch.models import Codec, WACNN

    model = WACNN(N=8, M=8, num_slices=2, max_support_slices=1)
    if torch.cuda.is_available():
        assert Codec(model).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Codec(model)


def test_entropy_coder_registry():
    import stf_tpu_torch
    from stf_tpu_torch.ans import host_coder_classes, resolve_host_backend

    assert stf_tpu_torch.available_entropy_coders() == ["rans", "rangecoder"]
    assert resolve_host_backend() == stf_tpu_torch.get_entropy_coder()
    with pytest.raises(ValueError):
        stf_tpu_torch.set_entropy_coder("nope")
    assert host_coder_classes("rangecoder")[0].__name__ == "BufferedRangeEncoder"
