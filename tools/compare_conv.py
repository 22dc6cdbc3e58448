"""The 3xTF32 convolution (`csrc/conv_tc.cu`) alone on the card: a fresh
build (nvcc's seconds, registers and spills), then `chip_smoke.phase_conv`
at the main path's shapes: each checked against an f64 convolution and
cuDNN's f32 error, bit-equal across batch and tile configurations, and
timed under every configuration beside cuDNN's F.conv2d and the bound.

    python3 tools/compare_conv.py

Needs a CUDA card.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    from chip_smoke import phase_conv, ptxas_summary
    from stf_tpu_torch import _native

    if not torch.cuda.is_available():
        print("compare_conv: no CUDA device", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _native.build_all(["convtc"], force=True)
    print(f"build: convtc {time.perf_counter() - t0:.1f} s")
    for line in ptxas_summary(_native.build_logs["convtc"]):
        print(f"ptxas convtc: {line}")
    phase_conv(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
