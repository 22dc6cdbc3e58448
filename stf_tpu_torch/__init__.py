"""stf_tpu_torch — the PyTorch/CUDA port of stf_tpu, for NVIDIA Hopper.

The JAX package `stf_tpu` is the reference this package is held against;
nothing here imports it (or JAX). Modules mirror its layout so each
counterpart is easy to find:

    stf_tpu_torch.ops       differentiable ops (LowerBound, ste_round, ...)
    stf_tpu_torch.ans       native C++ rANS coder (ctypes) + lane coder with
                            its CUDA encode, decode and layout-pin kernels
    stf_tpu_torch.entropy   entropy models and host-side CDF tables/coders
    stf_tpu_torch.layers    convs, GDN, window attention (CUDA core kernel),
                            Swin blocks
    stf_tpu_torch.models    WACNN, STF, the channel-AR base and the Codec
    stf_tpu_torch.zoo       registry, checkpoints, published RD curves and
                            the JAX-params -> state_dict bridge
    stf_tpu_torch.utils     metrics (PSNR, SSIM, MS-SSIM), BD-rate, the
                            numerical policy, FLOP / parameter counts
    stf_tpu_torch.datasets  image-folder loader and device prefetch
    stf_tpu_torch.training  RD losses, dual-Adam train state and steps,
                            checkpoints (single-file and sharded), the
                            trainer CLIs
    stf_tpu_torch.parallel  process groups, meshes, DDP and fully_shard
                            over torch.distributed
    stf_tpu_torch.cli       the eval CLI, rd_compare and prime_cache

Hand-written CUDA kernels live in `csrc/` and are built with nvcc for
sm_90a at first use (`stf_tpu_torch._native`).
"""

__version__ = "0.1.0"

_entropy_coder = "rans"
_available_entropy_coders = ["rans", "rangecoder"]


def available_entropy_coders():
    """List the names of the usable host entropy coder backends: "rans"
    (default 64-bit rANS) and "rangecoder" (carry-propagating range coder
    with the same symbol protocol). Streams are not interoperable between
    backends."""
    return list(_available_entropy_coders)


def set_entropy_coder(name: str) -> None:
    """Select the default host entropy coder backend by name."""
    global _entropy_coder
    if name not in _available_entropy_coders:
        raise ValueError(
            f"Unknown entropy coder {name!r} "
            f"(available: {', '.join(_available_entropy_coders)})"
        )
    _entropy_coder = name


def get_entropy_coder() -> str:
    """Return the name of the default host entropy coder backend."""
    return _entropy_coder
