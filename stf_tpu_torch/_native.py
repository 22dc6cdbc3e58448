"""Build and load the port's native libraries, and count kernel launches.

Six shared libraries with plain C interfaces, loaded with ctypes:

  * ``librans``        ``ans/csrc/rans_coder.cpp`` (host rANS + lane
                       encoder), built with ``g++``;
  * ``libwinattn``     ``csrc/window_attention.cu`` (kernel B1);
  * ``liblanedecode``  ``csrc/lane_decode.cu`` (kernel B2);
  * ``liblaneencode``  ``csrc/lane_encode.cu`` (kernel B3);
  * ``liblayoutpin``   ``csrc/layout_pin.cu`` (kernel B4);
  * ``libconvtc``      ``csrc/conv_tc.cu`` (the 3xTF32 convolution); the
                       five CUDA libraries built with ``nvcc`` for
                       ``sm_90a``.

Each builds at first use into ``stf_tpu_torch/build/`` (gitignored) and is
rebuilt when its source is newer than the binary. `build_all` starts every
compiler at once, so the CUDA builds cost one ``nvcc`` wall time. The rANS
library builds when ``stf_tpu_torch.ans`` is first imported; the CUDA
libraries, all of them, when a wrapper is first about to launch on a CUDA
tensor.

`launch_counts` holds one integer per kernel (and per shape for B1, per
path for B4, per kernel size for the convolution): each wrapper adds one
where it launches its kernel, and nowhere else. `build_logs` keeps each
compiler's output; the CUDA builds pass ``-Xptxas -v``, so it lists every
kernel's registers, shared memory and spills.
"""

import collections
import ctypes
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG_DIR, "build")

_SOURCES = {
    "rans": os.path.join(_PKG_DIR, "ans", "csrc", "rans_coder.cpp"),
    "winattn": os.path.join(_PKG_DIR, "csrc", "window_attention.cu"),
    "lanedecode": os.path.join(_PKG_DIR, "csrc", "lane_decode.cu"),
    "laneencode": os.path.join(_PKG_DIR, "csrc", "lane_encode.cu"),
    "layoutpin": os.path.join(_PKG_DIR, "csrc", "layout_pin.cu"),
    "convtc": os.path.join(_PKG_DIR, "csrc", "conv_tc.cu"),
}
CUDA_LIBS = ("winattn", "lanedecode", "laneencode", "layoutpin", "convtc")

launch_counts = collections.Counter()
build_logs = {}  # name -> the compiler's output of its last build here
_loaded = {}
_declarations = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _command(name: str, out: str):
    src = _SOURCES[name]
    if name == "rans":
        return [os.environ.get("CXX", "g++"), "-std=c++17", "-shared",
                "-fPIC", "-O3", "-DNDEBUG", "-o", out, src]
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler",
            "-fPIC", "-o", out, src]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _fresh(name: str) -> bool:
    lib = library_path(name)
    return (os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(_SOURCES[name]))


def build_all(names=None, force: bool = False):
    """Compile the named libraries (all by default) in parallel; returns
    {name: path}. Each compiler writes a temp file that is renamed into
    place, so a concurrent build never loads a half-written library."""
    names = list(_SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in names:
        if not force and _fresh(name):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((name, tmp, proc))
    errors = []
    for name, tmp, proc in jobs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"{name}: {' '.join(proc.args)}\n{log}")
        else:
            os.replace(tmp, library_path(name))
    if errors:
        raise RuntimeError("native build failed:\n" + "\n".join(errors))
    return {name: library_path(name) for name in names}


def declare(name: str, fn) -> None:
    """Register `fn(lib)`, which sets the argtypes/restype of the named
    library's entry points when it is loaded."""
    _declarations[name] = fn


def load(name: str) -> ctypes.CDLL:
    """The named library, built if needed and loaded once per process. A
    CUDA library's build also builds every other stale CUDA library, all
    compilers at once, so a fresh checkout pays one ``nvcc`` wall time
    whichever kernel it launches first."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all(CUDA_LIBS if name in CUDA_LIBS
                                    else [name])[name])
        _declarations[name](lib)
        _loaded[name] = lib
    return lib


def check_operand(t, name: str, dtype, device, shape) -> None:
    """Raise unless tensor `t` is contiguous, of `dtype`, on `device`, and
    of `shape` (a None entry matches any extent): what a kernel wrapper
    checks before it hands a raw pointer to a launch."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
