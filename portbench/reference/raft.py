"""RAFT (Teed & Deng, "RAFT: Recurrent All-Pairs Field Transforms for
Optical Flow", ECCV 2020, arXiv:2003.12039), the benchmark's plain
reference for the ``kitti_raft`` cells: written from the paper and the
published code (princeton-vl/RAFT ``core/raft.py``, ``core/extractor.py``,
``core/update.py``, ``core/corr.py``, ``core/utils/utils.py``) in plain
PyTorch. It imports nothing of the program and nothing of JAX; it has no
kernel, cache or graph.

The modules carry the published names, so the published state dict (and
the program's, which has the same names) loads strictly. The forward is
the published test-mode forward: both images through ``fnet``
(instance norm), the all-pairs volume ``fmap1^T fmap2 / sqrt(D)`` and
three 2 x 2 average poolings of it (``CorrBlock``), ``cnet`` (batch norm)
split into the GRU's state (tanh) and context (relu), ``iters`` updates
(the lookup as ``CorrBlock.__call__``: ``grid_sample`` with
``align_corners`` at ``coords / 2^i`` plus the 9 x 9 offsets of the
published meshgrid, then the motion encoder, ``SepConvGRU`` and the flow
head), then the convex upsampling (``RAFT.upsample_flow``).

Precision. ``dtype`` "float32" computes everything in f32; set
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False before calling (the judge
does). "bfloat16" computes as the published autocast: each convolution's
input, weight and bias in bf16 and its output bf16, so activations and the
GRU's gates work on bf16 values; the norms in f32, rounded back. The
volume, its pooling, the lookup, the coordinates and the upsampling stay
in f32 either way. The controls (``portbench/control_raft.py``) take
``encoder_dtype`` "float8" (the encoders' convolution operands and
results on the float8 e4m3 grid, f32 arithmetic), ``volume_dtype``
bfloat16 (the volume's product in bf16 where f32 is stated) and fewer
``iters``.

Departures from the published code, none of which changes a result the
cell compares:

* the images arrive in [0, 1] (the published in [0, 255]) and map to the
  same [-1, 1];
* the serving step pads the image on the right and at the bottom to a
  multiple of 8 (``step._flow_forward``); the published ``InputPadder``
  in its KITTI mode splits the width's padding between left and right;
* the camera's grey image is replicated to RGB's three channels;
* the mask head runs once, after the last update: the published loop
  runs it every iteration, and its test-mode output reads only the last;
* a pyramid level must be at least 2 pixels on each side (the published
  ``bilinear_sampler`` divides by ``W - 1`` and ``H - 1``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .pwc_net import FP8, cast


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """The published widths; ``in_channels`` and ``feature_channels`` are
    what ``step._flow_forward`` reads (3 channels; the stages' count fixes
    the padding multiple, 2^3 = 8)."""

    in_channels: int = 3
    feature_channels: Tuple[int, ...] = (64, 96, 128)
    feature_dim: int = 256
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 24
    dtype: str = "float32"
    encoder_dtype: str | None = None  # default: ``dtype``
    volume_dtype: str = "float32"


_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8": FP8}


def _conv(m: nn.Conv2d, x: torch.Tensor, dt) -> torch.Tensor:
    """``m`` applied with its operands (and, on the float8 grid, its
    result) in ``dt``."""
    out = F.conv2d(cast(x, dt), cast(m.weight, dt), cast(m.bias, dt),
                   m.stride, m.padding)
    return cast(out, dt) if dt == FP8 else out


def _norm(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A norm in f32, its result in the input's type."""
    return m(x.float()).to(x.dtype)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, kernel_size=3, padding=1,
                               stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, kernel_size=3, padding=1)
        norm = nn.BatchNorm2d if norm_fn == "batch" else nn.InstanceNorm2d
        self.norm1 = norm(planes)
        self.norm2 = norm(planes)
        if stride == 1:
            self.downsample = None
        else:
            self.norm3 = norm(planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, kernel_size=1, stride=stride),
                self.norm3)

    def run(self, x, dt):
        y = F.relu(_norm(self.norm1, _conv(self.conv1, x, dt)))
        y = F.relu(_norm(self.norm2, _conv(self.conv2, y, dt)))
        if self.downsample is not None:
            x = _norm(self.norm3, _conv(self.downsample[0], x, dt))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim, norm_fn, cfg: RAFTConfig):
        super().__init__()
        c = cfg.feature_channels
        norm = nn.BatchNorm2d if norm_fn == "batch" else nn.InstanceNorm2d
        self.norm1 = norm(c[0])
        self.conv1 = nn.Conv2d(cfg.in_channels, c[0], kernel_size=7,
                               stride=2, padding=3)
        self.layer1 = nn.Sequential(ResidualBlock(c[0], c[0], norm_fn, 1),
                                    ResidualBlock(c[0], c[0], norm_fn, 1))
        self.layer2 = nn.Sequential(ResidualBlock(c[0], c[1], norm_fn, 2),
                                    ResidualBlock(c[1], c[1], norm_fn, 1))
        self.layer3 = nn.Sequential(ResidualBlock(c[1], c[2], norm_fn, 2),
                                    ResidualBlock(c[2], c[2], norm_fn, 1))
        self.conv2 = nn.Conv2d(c[2], output_dim, kernel_size=1)

    def run(self, x, dt):
        x = F.relu(_norm(self.norm1, _conv(self.conv1, x, dt)))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block.run(x, dt)
        return _conv(self.conv2, x, dt)


class BasicMotionEncoder(nn.Module):
    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        cor_planes = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1, padding=0)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim, input_dim):
        super().__init__()
        c = hidden_dim + input_dim
        for name, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{name}",
                        nn.Conv2d(c, hidden_dim, k, padding=p))


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        self.encoder = BasicMotionEncoder(cfg)
        self.gru = SepConvGRU(cfg.hidden_dim, 128 + cfg.hidden_dim)
        self.flow_head = FlowHead(cfg.hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(
            nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(256, 64 * 9, 1, padding=0))


def coords_grid(batch, ht, wd, device):
    coords = torch.meshgrid(torch.arange(ht, device=device),
                            torch.arange(wd, device=device), indexing="ij")
    coords = torch.stack(coords[::-1], dim=0).float()
    return coords[None].repeat(batch, 1, 1, 1)


def bilinear_sampler(img, coords):
    """The published sampler: pixel coordinates normalised to [-1, 1],
    ``grid_sample`` with ``align_corners``, zeros outside."""
    h, w = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (w - 1) - 1
    ygrid = 2 * ygrid / (h - 1) - 1
    grid = torch.cat([xgrid, ygrid], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


def corr_pyramid(fmap1, fmap2, levels, volume_dtype=torch.float32):
    """``CorrBlock.__init__``: the all-pairs volume, then ``levels - 1``
    average poolings, each (B h w, 1, H_l, W_l) f32."""
    batch, dim, ht, wd = fmap1.shape
    f1 = fmap1.view(batch, dim, ht * wd).to(volume_dtype)
    f2 = fmap2.view(batch, dim, ht * wd).to(volume_dtype)
    corr = torch.matmul(f1.transpose(1, 2), f2).float()
    corr = corr.view(batch * ht * wd, 1, ht, wd) / math.sqrt(dim)
    pyramid = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    return pyramid


def lookup(pyramid, coords, radius):
    """``CorrBlock.__call__``: (B, L (2r+1)^2, h, w) f32."""
    r = radius
    coords = coords.permute(0, 2, 3, 1)
    batch, h1, w1, _ = coords.shape
    out = []
    for i, corr in enumerate(pyramid):
        dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        dy = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        delta = torch.stack(torch.meshgrid(dy, dx, indexing="ij"), dim=-1)
        centroid = coords.reshape(batch * h1 * w1, 1, 1, 2) / 2 ** i
        corr = bilinear_sampler(corr, centroid + delta.view(
            1, 2 * r + 1, 2 * r + 1, 2))
        out.append(corr.view(batch, h1, w1, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous().float()


class RAFT(nn.Module):
    def __init__(self, cfg: RAFTConfig = RAFTConfig()):
        super().__init__()
        self.config = cfg
        self.fnet = BasicEncoder(cfg.feature_dim, "instance", cfg)
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch",
                                 cfg)
        self.update_block = BasicUpdateBlock(cfg)

    def _update(self, net, inp, corr, flow, dt):
        ub = self.update_block
        e = ub.encoder
        cor = F.relu(_conv(e.convc1, corr, dt))
        cor = F.relu(_conv(e.convc2, cor, dt))
        flo = F.relu(_conv(e.convf1, flow, dt))
        flo = F.relu(_conv(e.convf2, flo, dt))
        out = F.relu(_conv(e.conv, torch.cat([cor, flo], dim=1), dt))
        x = torch.cat([inp, out, flow.to(out.dtype)], dim=1)
        g = ub.gru
        h = net
        for z_c, r_c, q_c in ((g.convz1, g.convr1, g.convq1),
                              (g.convz2, g.convr2, g.convq2)):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(_conv(z_c, hx, dt))
            r = torch.sigmoid(_conv(r_c, hx, dt))
            q = torch.tanh(_conv(q_c, torch.cat([r * h, x], dim=1), dt))
            h = (1 - z) * h + z * q
        fh = ub.flow_head
        delta = _conv(fh.conv2, F.relu(_conv(fh.conv1, h, dt)), dt)
        return h, delta

    def upsample_flow(self, flow, mask):
        n, _, h, w = flow.shape
        mask = torch.softmax(mask.float().view(n, 1, 9, 8, 8, h, w), dim=2)
        up_flow = F.unfold(8 * flow, [3, 3], padding=1)
        up_flow = up_flow.view(n, 2, 9, 1, 1, h, w)
        up_flow = torch.sum(mask * up_flow, dim=2)
        up_flow = up_flow.permute(0, 1, 4, 2, 5, 3)
        return up_flow.reshape(n, 2, 8 * h, 8 * w)

    def _encode(self, image1, image2):
        """(pyramid, GRU state, context, coords0) of a pair."""
        cfg = self.config
        dt = _TYPES[cfg.dtype]
        edt = _TYPES[cfg.encoder_dtype or cfg.dtype]
        image1 = 2 * image1 - 1.0
        image2 = 2 * image2 - 1.0
        fmaps = self.fnet.run(torch.cat([image1, image2], dim=0), edt)
        fmap1, fmap2 = fmaps.float().split(image1.shape[0], dim=0)
        pyramid = corr_pyramid(fmap1, fmap2, cfg.corr_levels,
                               _TYPES[cfg.volume_dtype])
        cnet = self.cnet.run(image1, edt)
        # The GRU's state and context, as the update block's convolutions
        # take them.
        cnet = cnet.to(dt) if dt != FP8 else cnet
        net, inp = torch.split(cnet, [cfg.hidden_dim, cfg.context_dim],
                               dim=1)
        n, _, h, w = fmap1.shape
        return (pyramid, torch.tanh(net), torch.relu(inp),
                coords_grid(n, h, w, image1.device))

    def first_lookup(self, image1, image2):
        """The features of the first update's lookup: the pyramid sampled
        around each pixel's own place."""
        pyramid, _, _, coords0 = self._encode(image1, image2)
        return lookup(pyramid, coords0, self.config.corr_radius)

    def forward(self, image1, image2):
        cfg = self.config
        dt = _TYPES[cfg.dtype]
        pyramid, net, inp, coords0 = self._encode(image1, image2)
        coords1 = coords0.clone()
        for _ in range(cfg.iters):
            corr = lookup(pyramid, coords1, cfg.corr_radius)
            net, delta = self._update(net, inp, corr, coords1 - coords0, dt)
            coords1 = coords1 + delta.float()
        m = self.update_block.mask
        mask = 0.25 * _conv(m[2], F.relu(_conv(m[0], net, dt)), dt)
        flow_low = coords1 - coords0
        return self.upsample_flow(flow_low, mask), flow_low


def raft_from_state(state: dict, cfg: RAFTConfig, device) -> RAFT:
    """The reference net of ``cfg`` holding ``state`` (the published
    names), loaded strictly, in eval mode on ``device``."""
    net = RAFT(cfg)
    net.load_state_dict(state, strict=True)
    return net.to(device).eval()
