"""PWC-Net's convolution operations from its widths and the input size.

Counted as ``torch.utils.flop_counter`` counts a convolution: 2 x the
multiply-adds, 2 * N * Cout * Hout * Wout * Cin * kh * kw, bias left
out. The correlation, the warps and the resizes are no convolutions and
are not counted; neither is anything outside the flow net (SGM,
ego-motion, scene flow, clustering, tracking). The layer list follows
``models/pwc_net.py`` of the port at fc97bde (the same architecture as
``portbench/reference/pwc_net.py``): the feature pyramid over both images
(two convolutions an octave, the first of stride 2), a DenseNet-style
estimator from the coarsest level down to level 2 (its convolutions, the
2-channel flow head and the 1 x 1 up-sampling features), and the dilated
context network at level 2.
"""

from __future__ import annotations


def _conv(n: int, h: int, w: int, cin: int, cout: int, k: int) -> int:
    return 2 * n * cout * h * w * cin * k * k


def padded(h: int, w: int, levels: int) -> tuple:
    """The net's input size: each side up to a multiple of 2**levels, as
    the serving step pads it."""
    m = 2 ** levels
    return -(-h // m) * m, -(-w // m) * m


def pwc_forward_flops(batch: int, h: int, w: int, in_channels: int,
                      feature_channels, estimator_channels,
                      context_channels, search_range: int,
                      occlusion_cue: bool = False,
                      use_context_net: bool = True) -> int:
    """Operations of one forward pass over ``batch`` pairs of (h, w)
    images, h and w multiples of 2**len(feature_channels)."""
    levels = len(feature_channels)
    if h % (2 ** levels) or w % (2 ** levels):
        raise ValueError(f"{h} x {w} is not a multiple of {2 ** levels}")
    total = 0
    cin, lh, lw = in_channels, h, w
    sizes = []
    for ch in feature_channels:  # both images of each pair
        lh, lw = lh // 2, lw // 2
        total += _conv(2 * batch, lh, lw, cin, ch, 3)
        total += _conv(2 * batch, lh, lw, ch, ch, 3)
        sizes.append((lh, lw))
        cin = ch
    corr = (2 * search_range + 1) ** 2
    top = levels - 1
    est_out = 0
    for lvl in range(top, 1, -1):
        lh, lw = sizes[lvl]
        c = corr + feature_channels[lvl] + (0 if lvl == top else 18) + (
            1 if occlusion_cue else 0)
        for ch in estimator_channels:
            total += _conv(batch, lh, lw, c, ch, 3)
            c += ch
        total += _conv(batch, lh, lw, c, 2, 3)  # flow head
        total += _conv(batch, lh, lw, c, 16, 1)  # up-sampling features
        est_out = c
    if use_context_net:
        lh, lw = sizes[2]
        c = est_out + 2
        for ch in context_channels:
            total += _conv(batch, lh, lw, c, ch, 3)
            c = ch
        total += _conv(batch, lh, lw, c, 2, 3)
    return total


def from_config(net: dict, batch: int, h: int, w: int) -> int:
    """``pwc_forward_flops`` for a configuration file's ``flownet``
    group, the input padded as the net pads it."""
    ph, pw = padded(h, w, len(net["feature_channels"]))
    return pwc_forward_flops(
        batch, ph, pw, net["in_channels"], net["feature_channels"],
        net["estimator_channels"], net["context_channels"],
        net["search_range"], net.get("occlusion_cue", False),
        net.get("use_context_net", True))
