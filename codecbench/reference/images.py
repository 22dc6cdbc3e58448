"""Seeded synthetic photographs (the recipe of the repository's
`smooth_batch`, drawn with a torch.Generator on the device).

Each image: base = 0.5 + a sin(x f1 + p1) cos(y f2 + p2), with spatial
frequencies of 0.5-6 periods over the width and the height, amplitude
0.1-0.35; its three channels are base and two copies rolled by 0-63
pixels along the width and the height; plus N(0, 0.03) sensor noise;
clipped to [0, 1] and stored as uint8.
"""

import math

import torch


def smooth_batch(n: int, h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n, h, w, 3) uint8 images on `device`, drawn from `gen`."""
    p = torch.rand(n, 7, generator=gen, device=device, dtype=torch.float64)
    f1 = 2 * math.pi * (0.5 + 5.5 * p[:, 0]) / w
    f2 = 2 * math.pi * (0.5 + 5.5 * p[:, 1]) / h
    amp = 0.1 + 0.25 * p[:, 2]
    ph1, ph2 = 7 * p[:, 3], 7 * p[:, 4]
    rolls = (64 * p[:, 5:7]).long().tolist()
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    col = lambda t: t.float()[:, None, None]  # noqa: E731
    base = 0.5 + col(amp) * torch.sin(xx * col(f1) + col(ph1)) * torch.cos(
        yy * col(f2) + col(ph2))
    chans = [base,
             torch.stack([torch.roll(b, r[0], 1) for b, r in zip(base, rolls)]),
             torch.stack([torch.roll(b, r[1], 0) for b, r in zip(base, rolls)])]
    img = torch.stack(chans, -1)
    img = img + 0.03 * torch.randn(img.shape, generator=gen, device=device)
    return torch.round(img.clamp(0, 1) * 255).to(torch.uint8)
