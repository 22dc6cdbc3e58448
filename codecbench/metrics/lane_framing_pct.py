"""Bytes of the lane y-streams that carry no symbol (header, index hashes,
format word, segment metadata, lane states, word padding), % of the stream
bytes (y and z) the window's compress calls returned."""
from codecbench.harness import program


def read(ctx):
    return program.lane_framing_pct(ctx)
