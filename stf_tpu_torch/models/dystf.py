"""DYSTF, STF with input-adaptive token pruning (port of
`stf_tpu/models/dystf.py`, eval branch).

Architecture and module names are the reference's
(`compressai/models/dystf.py`), so state_dict keys are the reference torch
keys: STF's, plus `layers.i.score_predictor.p` (`PredictorLG`: `in_conv`
= LN, Linear, GELU; `out_conv` = Linear, GELU, Linear, GELU, Linear,
LogSoftmax) and each pruned block's `fastmlp.fc1` (LN, Linear).

Eval routing (`dystf.py:135-165, 167-268` of the JAX package): at a
pruning location a stage's predictor scores every token; the
n_keep = int(N * ratio) best (a stable descending sort, so tied scores
keep token order) go through the block's MLP, the rest through its
`fastmlp`, and both are scattered back. Attention always runs on every
token. The schedule is the reference's, shared-list quirk included
(`pruning_schedule`). The training branch (Gumbel-softmax routing and its
two-tensor state, `is_teacher`) comes with dytrain (ROADMAP A.8); asking
for it raises.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..layers.swin import PatchMerging, SwinTransformerBlock
from .stf import SymmetricalTransFormer

_TRAINING = ("DYSTF's training branch (Gumbel-softmax routing, the "
             "two-tensor token state, is_teacher) is not ported: it comes "
             "with dytrain, ROADMAP A.8")


class FastMlp(nn.Module):
    """The dropped tokens' cheap MLP: LN + Linear (`dystf.py:42-56`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Sequential(nn.LayerNorm(dim, eps=1e-5),
                                 nn.Linear(dim, dim))

    def forward(self, x):
        return self.fc1(x)


class PredictorLG(nn.Module):
    """Token importance scorer (`dystf.py:155-200`): (B, N, C) tokens ->
    (B, N, 2) log-probabilities [keep, drop]. Its hidden features are half
    local, half the mean over the tokens."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_conv = nn.Sequential(nn.LayerNorm(dim, eps=1e-5),
                                     nn.Linear(dim, dim), nn.GELU())
        self.out_conv = nn.Sequential(
            nn.Linear(dim, dim // 2), nn.GELU(),
            nn.Linear(dim // 2, dim // 4), nn.GELU(),
            nn.Linear(dim // 4, 2), nn.LogSoftmax(dim=-1),
        )

    def forward(self, tokens):
        x = self.in_conv(tokens)
        half = x.shape[-1] // 2
        local = x[..., :half]
        glob = x[..., half:].mean(dim=1, keepdim=True)
        return self.out_conv(torch.cat([local, glob.expand_as(local)], -1))


class AdaSwinTransformerBlock(SwinTransformerBlock):
    """A Swin block whose MLP tail routes tokens (`dystf.py:299-399`): the
    attention on every token, then the kept ones through `mlp` and the
    dropped ones through `fastmlp`, scattered back."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 4,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        super().__init__(dim, num_heads, window_size, shift_size, mlp_ratio,
                         drop_path)
        self.fastmlp = FastMlp(dim)

    def forward(self, tokens, H: int, W: int, routed, sampler=None):
        """(B, H*W, C) tokens and routed = (keep, drop) token indexes
        (`route`) -> (B, H*W, C)."""
        B, _, C = tokens.shape
        keep, drop = routed
        x = tokens + self.drop_path(
            self.attend(tokens.reshape(B, H, W, C)).reshape(B, H * W, C),
            sampler)
        b = torch.arange(B, device=x.device)[:, None]
        filled = torch.zeros_like(x)
        filled[b, keep] = self.drop_path(self.mlp(self.norm2(x[b, keep])),
                                         sampler)
        filled[b, drop] = self.drop_path(self.fastmlp(x[b, drop]), sampler)
        return x + filled


def route(scores, ratio: float):
    """(keep, drop) token indexes, each (B, k) and (B, N - k), from (B, N)
    keep scores: the n_keep = int(N * ratio) best first, by a stable
    descending sort (tied scores keep token order), as JAX's
    `jnp.argsort(-scores)`."""
    n_keep = int(scores.shape[1] * ratio)
    order = torch.argsort(-scores, dim=1, stable=True)
    return order[:, :n_keep], order[:, n_keep:]


def pruning_schedule(depths: Sequence[int], pruning_locs: Sequence[int],
                     sparse_ratio: Sequence[float]):
    """Per stage, the (block, predictor, keep ratio) of each pruning step
    and the first block that routes its MLP tail, as the reference runs
    them (`dystf.py:736-762`, `DYSTF.setup` of the JAX package): it hands
    every stage the same lists while appending to them, so each stage
    sees the final (local offset, ratio) lists, with the predictor count
    it had when built; a step runs at block i when i is among the
    offsets, its predictor the next one, at that predictor's index's
    ratio. With the defaults (depths 2/2/6/2, locations 4/8/12, ratios
    0.9/0.7/0.5) stage 1 prunes at block 1 (0.9), stage 2 at blocks 1
    (0.9) and 3 (0.7), stage 3 at block 1 (0.9); 0.5 is never used.
    Returns [(steps, first routed block or None)] a stage."""
    entries, n_preds, block_cnt, p = [], [], 0, 0
    for depth in depths:
        former = block_cnt
        block_cnt += depth
        while p < len(pruning_locs) and block_cnt >= pruning_locs[p]:
            entries.append((pruning_locs[p] - former - 1, sparse_ratio[p]))
            p += 1
        n_preds.append(len(entries))
    locs = [e[0] for e in entries]
    ratios = [e[1] for e in entries]
    out = []
    for depth, n in zip(depths, n_preds):
        if not locs or n == 0:
            out.append(([], None))
            continue
        steps = []
        for i in range(depth):
            if len(steps) < n and i in locs:
                steps.append((i, len(steps), ratios[len(steps)]))
        out.append((steps, locs[0]))
    return out


class DyBasicLayer(nn.Module):
    """An STF analysis stage with token pruning (`dystf.py:488-633`):
    `blocks` (plain Swin blocks before the first routed one, then
    `AdaSwinTransformerBlock`s), `score_predictor` (the predictors its
    schedule calls), then PatchMerging as `downsample` when `merge`."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int = 4, mlp_ratio: float = 4.0,
                 drop_path: Sequence[float] = (), merge: bool = False,
                 steps=(), first_routed: Optional[int] = None):
        super().__init__()
        self.steps = {i: (p, ratio) for i, p, ratio in steps}
        first = depth if first_routed is None else first_routed
        self.blocks = nn.ModuleList(
            (SwinTransformerBlock if i < first else AdaSwinTransformerBlock)(
                dim, num_heads, window_size,
                shift_size=0 if i % 2 == 0 else window_size // 2,
                mlp_ratio=mlp_ratio,
                drop_path=drop_path[i] if i < len(drop_path) else 0.0,
            )
            for i in range(depth)
        )
        self.score_predictor = nn.ModuleList(
            PredictorLG(dim) for _ in self.steps)
        self.downsample = PatchMerging(dim) if merge else None

    def forward(self, x, sampler=None, decisions: Optional[List] = None):
        """NHWC map -> NHWC map; each pruning step's (keep, drop) indexes
        are appended to `decisions` when it is given."""
        if self.training:
            raise NotImplementedError(_TRAINING)
        B, H, W, C = x.shape
        routed = None
        for i, block in enumerate(self.blocks):
            if i in self.steps:
                p, ratio = self.steps[i]
                scores = self.score_predictor[p](x.reshape(B, H * W, C))
                routed = route(scores[..., 0], ratio)
                if decisions is not None:
                    decisions.append(routed)
            if isinstance(block, AdaSwinTransformerBlock):
                x = block(x.reshape(B, H * W, C), H, W, routed,
                          sampler).reshape(B, H, W, C)
            else:
                x = block(x, sampler)
        return x if self.downsample is None else self.downsample(x)


class DYSTF(SymmetricalTransFormer):
    """Dynamic-inference STF ("dystf" in the registry): STF's synthesis,
    hyper path and context model, an analysis of `DyBasicLayer`s."""

    def __init__(self, patch_size: int = 2, embed_dim: int = 48,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 4, num_slices: int = 12,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.2,
                 sparse_ratio: Sequence[float] = (0.9, 0.7, 0.5),
                 pruning_locs: Sequence[int] = (4, 8, 12)):
        super().__init__(patch_size, embed_dim, depths, num_heads,
                         window_size, num_slices, mlp_ratio, drop_path_rate)
        n = len(depths)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.schedule = pruning_schedule(depths, pruning_locs, sparse_ratio)
        stages, start = [], 0
        for i, (depth, (steps, first)) in enumerate(zip(depths,
                                                        self.schedule)):
            stages.append(DyBasicLayer(
                embed_dim * 2 ** i, depth, num_heads[i], window_size,
                mlp_ratio, dpr[start:start + depth], merge=i < n - 1,
                steps=steps, first_routed=first,
            ))
            start += depth
        self.layers = nn.ModuleList(stages)

    def analysis_with_decisions(self, x) -> Tuple[torch.Tensor, List]:
        """NCHW image -> (NCHW y, the last pruned stage's (keep, drop)
        index pairs), the decisions the JAX model returns."""
        x = self.patch_embed(x)
        final: List = []
        for layer in self.layers:
            decisions: List = []
            x = layer(x, decisions=decisions)
            if decisions:
                final = decisions
        return x.permute(0, 3, 1, 2).contiguous(), final

    def analysis(self, x, sampler=None):
        """NCHW image -> NCHW y (eval routing)."""
        return self.analysis_with_decisions(x)[0]

    def forward(self, x, training: bool = False, sampler=None) -> Dict:
        if training:
            raise NotImplementedError(_TRAINING)
        return super().forward(x, training, sampler)
