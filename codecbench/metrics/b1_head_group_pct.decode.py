"""FLOPs (4 N B H W C) of the window's decode calls' kernel B1 launches that
ran the head-group design, % of all their B1 FLOPs (the program's
counters). Below 100 where a geometry takes one block a (window, head):
the hyper transforms' 4x4 windows, or a silent fallback."""
from codecbench.harness import attn_route


def read(ctx):
    return attn_route.b1_head_group_pct(ctx, "decode")
