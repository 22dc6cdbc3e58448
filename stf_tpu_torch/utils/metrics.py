"""Image quality metrics (port of `stf_tpu/utils/metrics.py`), NHWC.

MS-SSIM is Wang et al.'s multi-scale SSIM with the usual constants
(11-tap Gaussian window, sigma 1.5, K1 = 0.01, K2 = 0.03, 5 scales), a
separable 'valid' blur, and the JAX package's two departures: images too
small for 5 scales use fewer, with the weights renormalised, and every
scale's term is floored at 1e-4 before the power (at 0, d/dv v^w is
infinite for w < 1, and the ms-ssim loss would NaN at random init).
"""

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0):
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x, win):
    """Separable depthwise Gaussian blur, 'valid' padding, on NCHW x."""
    C = x.shape[1]
    k = torch.as_tensor(win, dtype=x.dtype, device=x.device)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1).expand(C, 1, -1, 1), groups=C)
    return F.conv2d(x, k.reshape(1, 1, 1, -1).expand(C, 1, 1, -1), groups=C)


def _ssim_components(x, y, win, data_range: float):
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x = _blur(x, win)
    mu_y = _blur(y, win)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _blur(x * x, win) - mu_xx
    sigma_yy = _blur(y * y, win) - mu_yy
    sigma_xy = _blur(x * y, win) - mu_xy
    cs = (2 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return ssim_map.mean(), cs.mean()


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def ssim(x, y, data_range: float = 1.0, win_size: int = 11,
         sigma: float = 1.5):
    win = _gaussian_kernel(win_size, sigma)
    return _ssim_components(_nchw(x), _nchw(y), win, data_range)[0]


def ms_ssim(x, y, data_range: float = 1.0, win_size: int = 11,
            sigma: float = 1.5, weights=_MSSSIM_WEIGHTS):
    """Multi-scale SSIM of NHWC images; fewer scales, weights renormalised,
    where a scale would have under win_size pixels after its poolings."""
    win = _gaussian_kernel(win_size, sigma)
    levels = len(weights)
    min_side = min(x.shape[1], x.shape[2])
    max_levels = 1
    while max_levels < levels and (min_side // 2 ** max_levels) >= win_size:
        max_levels += 1
    if max_levels < levels:
        w = np.asarray(weights[:max_levels])
        weights = tuple(w / w.sum())
        levels = max_levels
    x, y = _nchw(x), _nchw(y)
    mcs = []
    for i in range(levels):
        s, cs = _ssim_components(x, y, win, data_range)
        if i < levels - 1:
            mcs.append(cs)
            x = F.avg_pool2d(x, 2)
            y = F.avg_pool2d(y, 2)
    vals = torch.clamp_min(torch.stack(mcs + [s]), 1e-4)
    w = torch.as_tensor(np.asarray(weights, np.float32), device=vals.device)
    return torch.prod(vals ** w)
