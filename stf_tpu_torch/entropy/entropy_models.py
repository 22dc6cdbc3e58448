"""Entropy models: factorized bottleneck + conditional Gaussian (port of
`stf_tpu/entropy/entropy_models.py`).

The bottleneck is an nn.Module with the reference's parameter names
(`_matrix{i}`, `_bias{i}`, `_factor{i}`, `quantiles`); tensors are NCHW.
The coding-path CDF tables are built on the host with NumPy/SciPy by the
same math as the JAX package and quantized by the port's native code,
so they are integer-identical to the JAX tables for the same parameters.

Training draws its U(-1/2, 1/2) quantization noise from a sampler
(`stf_tpu_torch.training.sampler.Sampler` or a test's replay of recorded
draws) in the JAX layouts: (C, 1, B*H*W) for the bottleneck, NHWC for a
Gaussian-conditioned slice.
"""

import dataclasses
import math
from statistics import NormalDist
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ans import (
    host_coder_classes,
    pmf_to_quantized_cdf_rows,
    resolve_host_backend,
)
from ..ops import lower_bound

# Ballé's TF-compression default scale grid (reference `models/cnn.py:14-20`).
SCALES_MIN = 0.11
SCALES_MAX = 256
SCALES_LEVELS = 64

LIKELIHOOD_BOUND = 1e-9
SCALE_BOUND = 0.11


def get_scale_table(
    min_scale: float = SCALES_MIN,
    max_scale: float = SCALES_MAX,
    levels: int = SCALES_LEVELS,
) -> np.ndarray:
    return np.exp(
        np.linspace(math.log(min_scale), math.log(max_scale), levels)
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# Factorized entropy bottleneck
# ---------------------------------------------------------------------------


class EntropyBottleneck(nn.Module):
    """Learned factorized prior (Ballé 2018). Forward: in training,
    additive U(-1/2, 1/2) noise models quantization; at eval the latent is
    rounded around the channel medians."""

    def __init__(self, channels: int, tail_mass: float = 1e-9,
                 init_scale: float = 10.0,
                 filters: Tuple[int, ...] = (3, 3, 3, 3),
                 likelihood_bound: float = LIKELIHOOD_BOUND):
        super().__init__()
        self.channels = channels
        self.tail_mass = tail_mass
        self.init_scale = init_scale
        self.filters = tuple(filters)
        self.likelihood_bound = likelihood_bound
        dims = (1,) + self.filters + (1,)
        self.n_stages = len(self.filters) + 1
        for i in range(self.n_stages):
            self.register_parameter(
                f"_matrix{i}",
                nn.Parameter(torch.empty(channels, dims[i + 1], dims[i])),
            )
            self.register_parameter(
                f"_bias{i}", nn.Parameter(torch.empty(channels, dims[i + 1], 1))
            )
            if i < self.n_stages - 1:
                self.register_parameter(
                    f"_factor{i}",
                    nn.Parameter(torch.empty(channels, dims[i + 1], 1)),
                )
        self.quantiles = nn.Parameter(torch.empty(channels, 1, 3))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        dims = (1,) + self.filters + (1,)
        scale = self.init_scale ** (1 / (len(self.filters) + 1))
        with torch.no_grad():
            for i in range(self.n_stages):
                init = math.log(math.expm1(1 / scale / dims[i + 1]))
                getattr(self, f"_matrix{i}").fill_(init)
                getattr(self, f"_bias{i}").uniform_(-0.5, 0.5, generator=generator)
                if i < self.n_stages - 1:
                    getattr(self, f"_factor{i}").zero_()
            self.quantiles.copy_(
                torch.tensor([-self.init_scale, 0.0, self.init_scale])
                .reshape(1, 1, 3).expand_as(self.quantiles)
            )

    def params_dict(self) -> dict:
        """JAX-named view: matrix_i / bias_i / factor_i / quantiles."""
        d = {"quantiles": self.quantiles}
        for i in range(self.n_stages):
            d[f"matrix_{i}"] = getattr(self, f"_matrix{i}")
            d[f"bias_{i}"] = getattr(self, f"_bias{i}")
            if i < self.n_stages - 1:
                d[f"factor_{i}"] = getattr(self, f"_factor{i}")
        return d

    def medians(self) -> torch.Tensor:
        """Per-channel medians (C,), detached."""
        return self.quantiles[:, 0, 1].detach()

    def _logits_cumulative(self, inputs, stop_gradient: bool = False):
        """Monotone per-channel CDF in logit space; with `stop_gradient`
        the chain's parameters are detached (the aux loss trains only
        `quantiles` through it)."""
        def param(name):
            t = getattr(self, name)
            return t.detach() if stop_gradient else t

        logits = inputs
        for i in range(self.n_stages):
            logits = torch.matmul(F.softplus(param(f"_matrix{i}")), logits)
            logits = logits + param(f"_bias{i}")
            if i < self.n_stages - 1:
                factor = param(f"_factor{i}")
                logits = logits + torch.tanh(factor) * torch.tanh(logits)
        return logits

    def aux_loss(self):
        """|logits(quantiles) - [-t, 0, t]| summed, t = log(2/tail_mass - 1),
        through the detached chain: its gradient reaches only `quantiles`."""
        t = math.log(2 / self.tail_mass - 1)
        targets = torch.tensor([-t, 0.0, t], dtype=torch.float32,
                               device=self.quantiles.device)
        logits = self._logits_cumulative(self.quantiles, stop_gradient=True)
        return torch.abs(logits - targets).sum()

    def _likelihood(self, values):
        lower = self._logits_cumulative(values - 0.5)
        upper = self._logits_cumulative(values + 0.5)
        sign = -torch.sign(lower + upper).detach()
        return torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))

    def forward(self, x, training: bool = False, sampler=None):
        """x: NCHW. Returns (x_tilde, likelihoods), both NCHW: x plus
        noise drawn from `sampler` in training, else x rounded around the
        medians."""
        B, C, H, W = x.shape
        values = x.permute(1, 0, 2, 3).reshape(C, 1, -1)
        if training:
            outputs = values + sampler.uniform(values.shape, values)
        else:
            medians = self.medians()[:, None, None]
            outputs = torch.round(values - medians) + medians
        likelihood = lower_bound(self._likelihood(outputs), self.likelihood_bound)
        outputs = outputs.reshape(C, B, H, W).permute(1, 0, 2, 3)
        likelihood = likelihood.reshape(C, B, H, W).permute(1, 0, 2, 3)
        return outputs, likelihood


# ---------------------------------------------------------------------------
# Conditional Gaussian
# ---------------------------------------------------------------------------


def _standardized_cumulative(x):
    # 0.5 * erfc(-x / sqrt(2)); erfc keeps precision in the tails
    return 0.5 * torch.special.erfc(-(2 ** -0.5) * x)


def gaussian_likelihood(values, scales, means=None,
                        scale_bound: float = SCALE_BOUND,
                        likelihood_bound: float = LIKELIHOOD_BOUND):
    """P(round(v) == v_hat) for v ~ N(means, scales^2); elementwise."""
    if means is not None:
        values = values - means
    scales = lower_bound(scales, scale_bound)
    values = torch.abs(values)
    upper = _standardized_cumulative((0.5 - values) / scales)
    lower_ = _standardized_cumulative((-0.5 - values) / scales)
    likelihood = upper - lower_
    if likelihood_bound > 0:
        likelihood = lower_bound(likelihood, likelihood_bound)
    return likelihood


def gaussian_forward(x, scales, means=None, training: bool = False,
                     sampler=None):
    """(x_tilde, likelihoods) of NCHW x: noise quantization in training
    (drawn from `sampler` in x's NHWC layout, as the JAX package draws
    it), rounding around the means at eval."""
    if training:
        noise = sampler.uniform(x.permute(0, 2, 3, 1).shape, x)
        outputs = x + noise.permute(0, 3, 1, 2)
    elif means is not None:
        outputs = torch.round(x - means) + means
    else:
        outputs = torch.round(x)
    return outputs, gaussian_likelihood(outputs, scales, means)


def gaussian_build_indexes(scales, scale_table: torch.Tensor):
    """Smallest scale-table entry >= scale (scales bounded below at 0.11),
    as an int32 index tensor: the count of entries of table[:-1] below the
    scale, exactly `searchsorted(table[:-1], scales, side="left")`."""
    scales = lower_bound(scales, SCALE_BOUND)
    return torch.bucketize(scales.contiguous(), scale_table[:-1]).to(torch.int32)


# ---------------------------------------------------------------------------
# Host-side CDF tables + coders
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CdfTables:
    """Quantized CDF tables consumed by the native rANS coder."""

    quantized_cdf: np.ndarray  # int32 [rows, max_len + 2]
    cdf_length: np.ndarray  # int32 [rows]
    offset: np.ndarray  # int32 [rows]

    def astuple(self):
        return self.quantized_cdf, self.cdf_length, self.offset


def build_eb_tables(eb: EntropyBottleneck, precision: int = 16) -> CdfTables:
    """The bottleneck's per-channel CDF tables (reference
    `EntropyBottleneck.update()`, `entropy_models.py:354-393`), evaluated
    in NumPy on the host."""
    eb_params = {
        k: v.detach().cpu().numpy() for k, v in eb.params_dict().items()
    }

    def logits_cumulative(params, inputs):
        n_stages = len([k for k in params if k.startswith("matrix_")])
        logits = inputs
        for i in range(n_stages):
            m = np.asarray(params[f"matrix_{i}"], np.float32)
            softplus = np.logaddexp(0.0, m)
            logits = np.einsum("cij,cjn->cin", softplus, logits) + np.asarray(
                params[f"bias_{i}"], np.float32
            )
            if i < n_stages - 1:
                f = np.asarray(params[f"factor_{i}"], np.float32)
                logits = logits + np.tanh(f) * np.tanh(logits)
        return logits

    quantiles = np.asarray(eb_params["quantiles"], np.float32)
    medians = quantiles[:, 0, 1]
    minima = np.clip(np.ceil(medians - quantiles[:, 0, 0]), 0, None).astype(
        np.int32
    )
    maxima = np.clip(np.ceil(quantiles[:, 0, 2] - medians), 0, None).astype(
        np.int32
    )

    offset = -minima
    pmf_start = medians - minima
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max())

    samples = (
        np.arange(max_length, dtype=np.float32)[None, :]
        + pmf_start[:, None, None]
    )  # (C, 1, max_length)

    params = {k: v for k, v in eb_params.items() if k != "quantiles"}
    lower = logits_cumulative(params, (samples - 0.5).astype(np.float32))
    upper = logits_cumulative(params, (samples + 0.5).astype(np.float32))
    sign = -np.sign(lower + upper)
    sigmoid = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    pmf = np.abs(sigmoid(sign * upper) - sigmoid(sign * lower))[:, 0, :]
    tail = sigmoid(lower[:, 0, 0]) + sigmoid(-upper[:, 0, -1])

    cdf = pmf_to_quantized_cdf_rows(pmf, tail, pmf_length, precision)
    return CdfTables(cdf, pmf_length + 2, offset)


def build_gc_tables(
    scale_table: np.ndarray,
    precision: int = 16,
    tail_mass: float = 1e-9,
) -> CdfTables:
    """One CDF row per scale-table entry (reference `update()`, `:599-624`)."""
    from scipy.special import erfc

    scale_table = np.asarray(scale_table, np.float32)
    multiplier = -NormalDist().inv_cdf(tail_mass / 2)
    pmf_center = np.ceil(scale_table * multiplier).astype(np.int32)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())

    samples = np.abs(
        np.arange(max_length, dtype=np.int32)[None, :] - pmf_center[:, None]
    ).astype(np.float32)
    s = scale_table[:, None]

    def phi(v):
        return 0.5 * erfc(-(2 ** -0.5) * np.asarray(v, np.float64))

    upper = phi((0.5 - samples) / s)
    lower = phi((-0.5 - samples) / s)
    pmf = upper - lower
    tail = 2 * lower[:, 0]

    cdf = pmf_to_quantized_cdf_rows(pmf, tail, pmf_length, precision)
    return CdfTables(cdf, pmf_length + 2, -pmf_center)


class EntropyBottleneckCoder:
    """Host-side compress/decompress for the factorized bottleneck: NHWC
    NumPy symbols, one rANS stream per batch element."""

    def __init__(self, tables: CdfTables, medians: np.ndarray,
                 backend: Optional[str] = None):
        self.tables = tables
        self.medians = np.asarray(medians, np.float32)  # (C,)
        # snapshot the backend now: compress and decompress must use the
        # same bit layer even if the package registry is flipped between
        self.backend = resolve_host_backend(backend)

    def compress_symbols(self, symbols: np.ndarray) -> list:
        """Encode pre-quantized NHWC symbols (rint(z - medians))."""
        symbols = np.asarray(symbols, np.int32)
        C = symbols.shape[-1]
        indexes = np.broadcast_to(
            np.arange(C, dtype=np.int32), symbols.shape[1:]
        )
        cdf, lengths, offsets = self.tables.astuple()
        enc = host_coder_classes(self.backend)[1]()
        return [
            enc.encode_with_indexes(s, indexes, cdf, lengths, offsets)
            for s in symbols
        ]

    def decompress_symbols(self, strings: list, spatial_shape) -> np.ndarray:
        """Decode to raw NHWC int32 symbols (B, *spatial, C), medians not
        added."""
        C = self.tables.cdf_length.shape[0]
        shape = tuple(spatial_shape) + (C,)
        indexes = np.broadcast_to(np.arange(C, dtype=np.int32), shape)
        cdf, lengths, offsets = self.tables.astuple()
        dec = host_coder_classes(self.backend)[2]()
        out = np.empty((len(strings),) + shape, np.int32)
        for b, s in enumerate(strings):
            out[b] = dec.decode_with_indexes(
                s, indexes, cdf, lengths, offsets
            ).reshape(shape)
        return out


class GaussianConditionalCoder:
    """Host-side tables for coding Gaussian-conditioned latents."""

    def __init__(self, tables: CdfTables, scale_table: np.ndarray,
                 backend: Optional[str] = None):
        self.tables = tables
        self.scale_table = np.asarray(scale_table, np.float32)
        self.backend = resolve_host_backend(backend)
