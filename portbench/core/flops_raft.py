"""RAFT's operations a pair from its widths and the input size.

Counted as ``torch.utils.flop_counter`` counts them: a convolution
2 * N * Cout * Hout * Wout * Cin * kh * kw (bias left out), a matrix
product 2 * M * N * K. The layers follow the published RAFT (arXiv:
2003.12039; princeton-vl/RAFT ``core/extractor.py``, ``core/update.py``,
``core/corr.py``) as ``portbench/reference/raft.py`` writes it: the
feature encoder over both images and the context encoder over the first
(three encoder passes), the all-pairs volume (an f32 product), ``iters``
updates (motion encoder, separable GRU, flow head) and the mask head once.
The pooling, the lookup, the GRU's gates and the convex upsampling are no
convolution or product and are not counted; nor is anything outside the
flow net (SGM, ego-motion, scene flow, clustering, tracking). At the
KITTI grid (376 x 1248, 47 x 156 at 1/8): 191 GFLOP in the encoders, 27.5
in the volume, 941 in 24 updates, 6.5 in the mask head.
"""

from __future__ import annotations


def _conv(n: int, h: int, w: int, cin: int, cout: int, kh: int,
          kw: int | None = None) -> int:
    return 2 * n * cout * h * w * cin * kh * (kh if kw is None else kw)


def encoder_flops(n: int, h: int, w: int, cin: int, stages, out_dim: int
                  ) -> int:
    """One ``BasicEncoder`` over n images of (h, w)."""
    h, w = -(-h // 2), -(-w // 2)
    total = _conv(n, h, w, cin, stages[0], 7)
    c = stages[0]
    for i, s in enumerate(stages):
        if i:  # the stage's first block has stride 2 and a 1 x 1 shortcut
            h, w = -(-h // 2), -(-w // 2)
            total += _conv(n, h, w, c, s, 3) + _conv(n, h, w, c, s, 1)
        else:
            total += _conv(n, h, w, c, s, 3)
        total += 3 * _conv(n, h, w, s, s, 3)
        c = s
    return total + _conv(n, h, w, c, out_dim, 1)


def update_flops(n: int, h: int, w: int, corr_planes: int, hidden: int,
                 context: int) -> int:
    """One update at the (h, w) grid: motion encoder, GRU, flow head."""
    total = (_conv(n, h, w, corr_planes, 256, 1)
             + _conv(n, h, w, 256, 192, 3) + _conv(n, h, w, 2, 128, 7)
             + _conv(n, h, w, 128, 64, 3) + _conv(n, h, w, 256, 126, 3))
    total += 6 * _conv(n, h, w, hidden + context + 128, hidden, 1, 5)
    return total + _conv(n, h, w, hidden, 256, 3) + _conv(n, h, w, 256, 2, 3)


def raft_forward_flops(batch: int, h: int, w: int, net: dict) -> dict:
    """{part: operations} of one forward over ``batch`` pairs of (h, w)
    images, h and w multiples of 8; ``net`` a configuration's
    ``flownet`` group."""
    stages = net["feature_channels"]
    if h % 8 or w % 8:
        raise ValueError(f"{h} x {w} is not a multiple of 8")
    gh, gw = h // 8, w // 8
    cin = net["in_channels"]
    hidden, context = net["hidden_dim"], net["context_dim"]
    planes = net["corr_levels"] * (2 * net["corr_radius"] + 1) ** 2
    return {
        "encoders": (encoder_flops(2 * batch, h, w, cin, stages,
                                   net["feature_dim"])
                     + encoder_flops(batch, h, w, cin, stages,
                                     hidden + context)),
        "volume": 2 * batch * (gh * gw) ** 2 * net["feature_dim"],
        "updates": net["iters"] * update_flops(batch, gh, gw, planes,
                                               hidden, context),
        "mask": (_conv(batch, gh, gw, hidden, 256, 3)
                 + _conv(batch, gh, gw, 256, 64 * 9, 1)),
    }


def from_config(net: dict, batch: int, h: int, w: int) -> int:
    """Operations of a forward at (h, w) padded to a multiple of 8 on the
    right and at the bottom, as the serving step pads it."""
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    return sum(raft_forward_flops(batch, ph, pw, net).values())
