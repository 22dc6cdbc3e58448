"""The convolutions that the benchmark's four cells route to the 3xTF32
kernel (`layers.conv_core`) at a 512x768 image: (C_in, C_out, k, H, W) of
each f32 stride-1 `Conv2d` of WACNN's and STF's coding paths (hyper
synthesis, slice stacks, WACNN's synthesis attention blocks, STF's
end_conv), read off the models' calls. Imports no JAX."""

WACNN = [
    # hyper synthesis (z at 8x12, two 2x sub-pixel steps)
    (192, 192, 3, 8, 12), (192, 896, 3, 8, 12), (224, 256, 3, 16, 24),
    (256, 1152, 3, 16, 24), (288, 320, 3, 32, 48),
    # slice stacks at y (32x48): the first layer's inputs, then the rest
    (320, 224, 3, 32, 48), (352, 224, 3, 32, 48), (384, 224, 3, 32, 48),
    (416, 224, 3, 32, 48), (448, 224, 3, 32, 48), (480, 224, 3, 32, 48),
    (512, 224, 3, 32, 48), (224, 176, 3, 32, 48), (176, 128, 3, 32, 48),
    (128, 64, 3, 32, 48), (64, 32, 3, 32, 48),
    # synthesis attention blocks' residual units and gates
    (320, 160, 1, 32, 48), (160, 160, 3, 32, 48), (160, 320, 1, 32, 48),
    (320, 320, 1, 32, 48), (192, 96, 1, 128, 192), (96, 96, 3, 128, 192),
    (96, 192, 1, 128, 192), (192, 192, 1, 128, 192),
]
STF = [
    (192, 240, 3, 8, 12), (240, 1152, 3, 8, 12), (288, 336, 3, 16, 24),
    (336, 1536, 3, 16, 24), (384, 384, 3, 32, 48),
    (384, 224, 3, 32, 48), (416, 224, 3, 32, 48), (448, 224, 3, 32, 48),
    (480, 224, 3, 32, 48), (512, 224, 3, 32, 48), (544, 224, 3, 32, 48),
    (576, 224, 3, 32, 48), (608, 224, 3, 32, 48),
    # end_conv
    (48, 192, 5, 256, 384), (48, 3, 3, 512, 768),
]
# a pruned CC_GD's odd widths: K not a multiple of 4, N not of 8
ODD = [(61, 37, 3, 32, 48), (45, 203, 1, 32, 48), (29, 11, 5, 19, 23)]


def routed(transposed=False):
    """Every distinct shape of the two models and the odd widths, at
    512x768 or (`transposed`) 768x512."""
    out = []
    for s in WACNN + STF + ODD:
        if s not in out:
            out.append(s)
    if transposed:
        out = [(ci, co, k, w, h) for ci, co, k, h, w in out]
    return out

# The 5x5 stride-2 transposed convolutions (`layers.conv.ConvTranspose2d`)
# routed to the kernel's sub-pixel phases at a 512x768 image: (C_in, C_out,
# H, W) of each call's input. WACNN's synthesis (CC's and CC_GD's at full
# width are the same), CC's hyper synthesis, and a pruned CC_GD's odd
# widths, C_out < 8 and 11 among them (the joint form).
DECONV_WACNN = [(320, 192, 32, 48), (192, 192, 64, 96), (192, 192, 128, 192),
                (192, 3, 256, 384)]
DECONV_CC = [(192, 192, 8, 12), (192, 256, 16, 24)]
DECONV_ODD = [(61, 37, 8, 12), (37, 203, 16, 24), (45, 11, 16, 24),
              (29, 5, 19, 23)]


def routed_transposed(transposed=False):
    """Every transposed convolution above, at 512x768 or (`transposed`)
    768x512."""
    out = DECONV_WACNN + DECONV_CC + DECONV_ODD
    if transposed:
        out = [(ci, co, w, h) for ci, co, h, w in out]
    return out
