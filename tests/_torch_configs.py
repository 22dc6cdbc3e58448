"""The small configurations of the port's model tests, by registry name.
Imports no JAX, so the card tests (`tests/test_torch_cuda.py`) use them as
the CPU tests do."""

# the size tests/test_lane_codec.py uses
SMALL = dict(N=32, M=40, num_slices=4, max_support_slices=2)
# a small STF at the full model's head width 16 (B1's stf geometry):
# stages of 16, 32, 64 and 128 channels, y of 128 in 4 slices of 32
STF_SMALL = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
                 num_slices=4)
# a small TBC whose B1 geometries are the full model's: 8x8 windows at
# head widths 4, 6, 8 and 10 (4 heads over 16/24/32/40 channels), the
# hyper stacks' 4x4 at 6 (4 heads over 24); y of 40 channels in 6 slices
# of 7, 7, 7, 7, 7 and 5 (uneven), 3 of them as support
TBC_SMALL = dict(depths=(2, 2, 2, 2), h_depths=(2, 1), num_heads=4,
                 h_num_heads=4, channels=(16, 24, 32, 40, 24, 24),
                 num_slices=6)
# a small DYSTF at STF_SMALL's head width 16 with a schedule that shows
# the shared-list quirk: shared offsets (1, 1, 0), so stage 1 scores at
# block 0 and stages 2 and 3 at blocks 0 and 1 (predictors 0 and 1)
DYSTF_SMALL = dict(embed_dim=16, depths=(2, 2, 4, 2), num_heads=(1, 2, 4, 8),
                   num_slices=4, pruning_locs=(4, 6, 9),
                   sparse_ratio=(0.75, 0.5, 0.25))
CONFIGS = {"cnn": SMALL, "stf": STF_SMALL, "tbc": TBC_SMALL, "cc": SMALL,
           "cc_gd": SMALL, "dystf": DYSTF_SMALL}
