"""RAFT optical flow (Teed & Deng, "RAFT: Recurrent All-Pairs Field
Transforms for Optical Flow", ECCV 2020, arXiv:2003.12039) as PyTorch
modules, NCHW: the port's second flow architecture beside PWC-Net.

The module tree and the parameter names are the published ones
(princeton-vl/RAFT ``core/raft.py``, ``core/extractor.py``,
``core/update.py``): ``fnet`` (instance norm, both images) and ``cnet``
(batch norm, the first image) are ``BasicEncoder``s, ``update_block``
holds the motion ``encoder``, the ``gru``, the ``flow_head`` and the
``mask`` head. So a published state dict, its ``module.`` prefix
stripped, loads strictly (``utils/checkpoint.load_raft_state_dict``).

The forward is the published test-mode forward: the all-pairs volume
``fmap1^T fmap2 / sqrt(D)`` and three average-pooled levels over the
second image's axes, then ``iters`` updates, each a lookup of the pyramid
around the current match (``ops/raft_lookup_cuda.py``: the CUDA kernel
for the "pallas" backend, the plain version for "xla"), the motion
encoder, the separable convolutional GRU and the flow head; then the
convex 8x upsampling. Precision as the published autocast runs it:
every convolution's input, weight and bias in ``config.dtype`` (bf16)
and its output too, so the activations and the GRU's gates between them
work on bf16 values; the norms compute in f32 and round back. The
correlation volume, its pooling, the lookup, the coordinates and the
convex upsampling stay in f32.

Two departures leave the output the published one. The mask head runs
once, after the last update: the published loop runs it at every
iteration, but its test-mode output reads only the last iteration's mask.
Images arrive in [0, 1] and map to [-1, 1] as the published [0, 255] do.

Inside ``detect_step`` the encoders, the volume and its pyramid are span
``raft_encode``, the updates and the upsampling span ``raft_update``
(``utils/profiling.py``); counters ``raft_iterations`` and
``raft_lookups``. ``replay_spans`` names the spans of a replayed CUDA
graph of the forward (``pipeline._flow_forward``): its first segment,
which ends at the first lookup, and the rest.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import RAFTConfig
from ..ops import raft_lookup_cuda, resolve_backend
from ..utils import profiling

# The published widths outside the configuration's: the motion encoder's
# (``BasicMotionEncoder``) and the heads' (``FlowHead``, ``mask``).
CORR_HIDDEN = (256, 192)  # convc1, convc2
FLOW_HIDDEN = (128, 64)  # convf1 (7 x 7), convf2
MOTION_DIM = 128  # conv's 126 and the flow's 2
HEAD_HIDDEN = 256  # the flow head's and the mask head's hidden width
UPSAMPLE = 8  # the convex upsampling's factor


def _dtype(cfg: RAFTConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose input, weight and bias are cast to
    ``compute_dtype`` before the convolution (autocast's rule); the
    parameters are stored in f32."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm computed in f32 and returned in its input's type."""

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class InstanceNorm2d(nn.InstanceNorm2d):
    """Instance norm (no parameters) computed in f32 and returned in its
    input's type."""

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


def _norm(kind: str, planes: int) -> nn.Module:
    return BatchNorm2d(planes) if kind == "batch" else InstanceNorm2d(planes)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.relu = nn.ReLU(inplace=True)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        if stride == 1:
            self.downsample = None
        else:
            # Registered twice, as ``norm3`` and ``downsample.1``, as
            # published: its state dict holds both names.
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class BasicEncoder(nn.Module):
    """A 7 x 7 stride-2 stem, residual stages at 1/2, 1/4 and 1/8, a 1 x 1
    to ``output_dim``."""

    def __init__(self, output_dim: int, norm_fn: str, in_channels: int,
                 stages):
        super().__init__()
        self.norm_fn = norm_fn
        self.norm1 = _norm(norm_fn, stages[0])
        self.conv1 = Conv2d(in_channels, stages[0], 7, stride=2, padding=3)
        self.relu1 = nn.ReLU(inplace=True)
        self.in_planes = stages[0]
        self.layer1 = self._make_layer(stages[0], stride=1)
        self.layer2 = self._make_layer(stages[1], stride=2)
        self.layer3 = self._make_layer(stages[2], stride=2)
        self.conv2 = Conv2d(stages[2], output_dim, 1)

    def _make_layer(self, dim: int, stride: int) -> nn.Sequential:
        layers = (ResidualBlock(self.in_planes, dim, self.norm_fn, stride),
                  ResidualBlock(dim, dim, self.norm_fn, 1))
        self.in_planes = dim
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu1(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class FlowHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = Conv2d(hidden_dim, 2, 3, padding=1)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        return self.conv2(self.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    """A horizontal (1 x 5) and then a vertical (5 x 1) GRU step."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz1 = Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))

    def _step(self, h, x, convz, convr, convq):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(convz(hx))
        r = torch.sigmoid(convr(hx))
        q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        h = self._step(h, x, self.convz1, self.convr1, self.convq1)
        return self._step(h, x, self.convz2, self.convr2, self.convq2)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, CORR_HIDDEN[0], 1)
        self.convc2 = Conv2d(CORR_HIDDEN[0], CORR_HIDDEN[1], 3, padding=1)
        self.convf1 = Conv2d(2, FLOW_HIDDEN[0], 7, padding=3)
        self.convf2 = Conv2d(FLOW_HIDDEN[0], FLOW_HIDDEN[1], 3, padding=1)
        self.conv = Conv2d(CORR_HIDDEN[1] + FLOW_HIDDEN[1], MOTION_DIM - 2,
                           3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow.to(out.dtype)], dim=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_planes: int, hidden_dim: int, context_dim: int):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden_dim, context_dim + MOTION_DIM)
        self.flow_head = FlowHead(hidden_dim, HEAD_HIDDEN)
        self.mask = nn.Sequential(
            Conv2d(hidden_dim, HEAD_HIDDEN, 3, padding=1),
            nn.ReLU(inplace=True),
            Conv2d(HEAD_HIDDEN, UPSAMPLE * UPSAMPLE * 9, 1))

    def forward(self, net, inp, corr, flow):
        """(hidden state, flow update); the mask head is ``upsample_mask``."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)

    def upsample_mask(self, net):
        # Scaled by 0.25 to balance gradients, as published.
        return 0.25 * self.mask(net)


def coords_grid(batch: int, h: int, w: int, device) -> torch.Tensor:
    """(batch, 2, h, w) f32 pixel coordinates, x then y."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=0).float()[None].repeat(batch, 1, 1, 1)


def correlation_pyramid(fmap1, fmap2, levels: int) -> list:
    """The all-pairs volume of two (B, D, h, w) f32 feature maps,
    ``fmap1^T fmap2 / sqrt(D)`` in f32, and ``levels - 1`` 2 x 2 average
    poolings of it over the second map's axes: a list of (B h w, H_l, W_l)
    f32 levels."""
    b, d, h, w = fmap1.shape
    corr = torch.matmul(fmap1.reshape(b, d, h * w).transpose(1, 2),
                        fmap2.reshape(b, d, h * w)) / math.sqrt(d)
    corr = corr.reshape(b * h * w, 1, h, w)
    pyramid = [corr[:, 0]]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr[:, 0])
    return pyramid


def convex_upsample(flow, mask) -> torch.Tensor:
    """(B, 2, h, w) flow to (B, 2, 8h, 8w): each fine pixel a softmax-
    weighted combination of 8 x the flow of the coarse pixel's 3 x 3
    neighbourhood, with (B, 576, h, w) ``mask`` logits; in f32."""
    n, _, h, w = flow.shape
    s = UPSAMPLE
    mask = torch.softmax(mask.float().view(n, 1, 9, s, s, h, w), dim=2)
    up = F.unfold(s * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, s * h, s * w)


class RAFT(nn.Module):
    """Input: two (B, C, H, W) images in [0, 1], H and W multiples of 8.
    Output: (flow_up (B, 2, H, W), flow_low (B, 2, H/8, W/8)), f32, in
    pixels."""

    replay_spans = ("raft_encode", "raft_update")

    def __init__(self, config: RAFTConfig = RAFTConfig()):
        super().__init__()
        self.config = cfg = config
        self.fnet = BasicEncoder(cfg.feature_dim, "instance",
                                 cfg.in_channels, cfg.feature_channels)
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch",
                                 cfg.in_channels, cfg.feature_channels)
        corr_planes = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.update_block = BasicUpdateBlock(corr_planes, cfg.hidden_dim,
                                             cfg.context_dim)
        dt = _dtype(cfg)
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.compute_dtype = dt

    def _lookup(self, pyramid, coords, backend: str):
        r = self.config.corr_radius
        profiling.count("raft_lookups")
        if backend == "pallas":
            return raft_lookup_cuda.raft_lookup(pyramid, coords, r)
        return raft_lookup_cuda.raft_lookup_plain(pyramid, coords, r)

    def forward(self, image1, image2, corr_backend: str | None = None):
        """``corr_backend`` (the lookup's) overrides
        ``config.corr_backend``; the pipeline passes its
        ``PipelineConfig.flownet.corr_backend``."""
        cfg = self.config
        backend = resolve_backend(corr_backend or cfg.corr_backend,
                                  image1.device)
        b = image1.shape[0]
        image1 = 2.0 * image1 - 1.0
        image2 = 2.0 * image2 - 1.0
        with profiling.span("raft_encode"):
            fmaps = self.fnet(torch.cat([image1, image2], dim=0)).float()
            pyramid = correlation_pyramid(fmaps[:b], fmaps[b:],
                                          cfg.corr_levels)
            cnet = self.cnet(image1)
            net = torch.tanh(cnet[:, :cfg.hidden_dim])
            inp = torch.relu(cnet[:, cfg.hidden_dim:])
        with profiling.span("raft_update"):
            _, _, h, w = fmaps.shape
            coords0 = coords_grid(b, h, w, image1.device)
            coords1 = coords0.clone()
            for _ in range(cfg.iters):
                corr = self._lookup(pyramid, coords1, backend)
                net, delta = self.update_block(net, inp, corr,
                                               coords1 - coords0)
                coords1 = coords1 + delta.float()
                profiling.count("raft_iterations")
            flow_low = coords1 - coords0
            flow_up = convex_upsample(flow_low,
                                      self.update_block.upsample_mask(net))
        return flow_up, flow_low


def init_raft_params(model: RAFT, generator: torch.Generator | None = None
                     ) -> RAFT:
    """Draw every parameter afresh as the published modules initialise
    them, from ``generator``: PyTorch's default for every convolution,
    then the encoders' own rule (Kaiming-normal kernels, fan out, ReLU
    gain; norms' weights 1 and biases 0)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                         generator=generator)
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        for enc in (model.fnet, model.cnet):
            for m in enc.modules():
                if isinstance(m, nn.Conv2d):
                    nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                            nonlinearity="relu",
                                            generator=generator)
                elif isinstance(m, nn.BatchNorm2d):
                    nn.init.constant_(m.weight, 1.0)
                    nn.init.constant_(m.bias, 0.0)
    return model
