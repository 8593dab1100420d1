"""PWC-Net optical flow (the JAX package's ``models/pwc_net.py``) as
PyTorch modules, NCHW.

Same architecture and the same arithmetic as the Flax model: a siamese
feature pyramid, per-level bilinear warp of the second image's features,
the local correlation (CUDA kernel on CUDA tensors), DenseNet-style
estimators with the optional occlusion cue, and the dilated context
network at level 2. Convolutions compute in the config's dtype (bf16 by
default) with f32 flow heads, as Flax casts inputs and parameters to the
layer dtype; parameters are stored in f32. The context network uses
``dilation=d`` directly: the JAX package's space_to_batch lowering is a
TPU workaround for the same function.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import FlowNetConfig
from ..ops import flow_ops, resolve_backend


def _dtype(cfg: FlowNetConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _correlation_dispatch(f1, f2, search_range: int, backend: str):
    """FlowNetConfig.corr_backend: "pallas" = the CUDA kernels forward and
    backward (``flow_corr_cuda.correlation``, a ``torch.autograd.Function``;
    its plain versions on CPU tensors), "xla" = the plain form under
    autograd, "auto" by device."""
    if resolve_backend(backend, f1.device) == "pallas":
        from ..ops.flow_corr_cuda import correlation

        return correlation(f1, f2, search_range)
    return flow_ops.correlation(f1, f2, search_range)


def _same_pad(size: int, k: int, stride: int, dilation: int):
    """XLA "SAME" padding (extra pixel on the high side)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


# Standard deviation of a unit normal truncated to [-2, 2]: Flax's
# variance_scaling divides by it so the truncated draw keeps its variance.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """Flax's default ``nn.Conv`` kernel init, ``lecun_normal``, in place:
    a normal of variance 1 / fan_in (fan_in = in channels x kernel area)
    truncated at +-2 standard deviations."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0,
                              generator=generator)
        weight.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)
    return weight


class Conv(nn.Module):
    """Flax ``nn.Conv`` semantics: SAME padding; input, kernel and bias
    cast to ``dtype`` before the convolution; Flax's initialisation
    (``lecun_normal`` kernel, zero bias)."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        lecun_normal_(self.weight)
        self.stride = stride
        self.dilation = dilation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        ph = _same_pad(x.shape[-2], k, self.stride, self.dilation)
        pw = _same_pad(x.shape[-1], k, self.stride, self.dilation)
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        b = self.bias.to(self.dtype)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, w, b, self.stride, (ph[0], pw[0]),
                            self.dilation)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, w, b, self.stride, 0, self.dilation)


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


class FeaturePyramid(nn.Module):
    """Two convs per octave (stride 2, then 1); returns every level."""

    def __init__(self, in_ch: int, channels, dtype):
        super().__init__()
        convs = []
        for ch in channels:
            convs += [Conv(in_ch, ch, stride=2, dtype=dtype),
                      Conv(ch, ch, dtype=dtype)]
            in_ch = ch
        self.convs = nn.ModuleList(convs)

    def forward(self, img):
        feats = []
        x = img
        for i in range(0, len(self.convs), 2):
            x = _lrelu(self.convs[i](x))
            x = _lrelu(self.convs[i + 1](x))
            feats.append(x)
        return feats


class FlowEstimator(nn.Module):
    """DenseNet-style decoder: returns (dense stack, up features, flow)."""

    def __init__(self, in_ch: int, channels, dtype, up_channels: int = 16):
        super().__init__()
        convs = []
        for ch in channels:
            convs.append(Conv(in_ch, ch, dtype=dtype))
            in_ch += ch
        self.convs = nn.ModuleList(convs)
        self.flow_head = Conv(in_ch, 2, dtype=torch.float32)
        self.up = Conv(in_ch, up_channels, k=1, dtype=dtype)
        self.out_channels = in_ch

    def forward(self, x):
        for conv in self.convs:
            x = torch.cat([x, _lrelu(conv(x))], dim=1)
        return x, self.up(x), self.flow_head(x.float())


class ContextNetwork(nn.Module):
    """Dilated refinement at the finest estimated level."""

    def __init__(self, in_ch: int, channels, dtype):
        super().__init__()
        dilations = (1, 2, 4, 8, 16, 1)[: len(channels)]
        convs = []
        for ch, dil in zip(channels, dilations):
            convs.append(Conv(in_ch, ch, dilation=dil, dtype=dtype))
            in_ch = ch
        self.convs = nn.ModuleList(convs)
        self.residual = Conv(in_ch, 2, dtype=torch.float32)
        self.dtype = dtype

    def forward(self, features, flow):
        x = torch.cat([features, flow.to(self.dtype)], dim=1)
        for conv in self.convs:
            x = _lrelu(conv(x))
        return flow + self.residual(x.float())


class PWCNet(nn.Module):
    """Coarse-to-fine flow. Input: two (B, C, H, W) images in [0, 1] with H
    and W divisible by 2**pyramid_levels. Output: (B, 2, H, W) flow in
    pixels plus the per-level flows, finest first."""

    def __init__(self, config: FlowNetConfig = FlowNetConfig()):
        super().__init__()
        cfg = config
        assert len(cfg.feature_channels) >= 3, (
            "need >= 3 pyramid levels (flow is estimated down to level 2)")
        self.config = cfg
        dt = _dtype(cfg)
        self.pyramid = FeaturePyramid(cfg.in_channels, cfg.feature_channels,
                                      dt)
        corr = (2 * cfg.search_range + 1) ** 2
        occ = 1 if cfg.occlusion_cue else 0
        top = len(cfg.feature_channels) - 1
        ests = []
        for lvl in range(top, 1, -1):
            extra = 0 if lvl == top else 16 + 2
            ests.append(FlowEstimator(
                corr + cfg.feature_channels[lvl] + extra + occ,
                cfg.estimator_channels, dt))
        self.estimators = nn.ModuleList(ests)
        self.context = (
            ContextNetwork(ests[-1].out_channels + 2, cfg.context_channels,
                           dt)
            if cfg.use_context_net else None)

    def forward(self, img1, img2, corr_backend: str | None = None):
        """``corr_backend`` overrides ``config.corr_backend``; the pipeline
        passes its ``PipelineConfig.flownet.corr_backend``."""
        cfg = self.config
        corr_backend = corr_backend or cfg.corr_backend
        dt = _dtype(cfg)
        b, _, h, w = img1.shape
        both = self.pyramid(torch.cat([img1, img2], dim=0).to(dt))
        f1s = [f[:b] for f in both]
        f2s = [f[b:] for f in both]
        flows = []
        flow = None
        up_feat = None
        top = len(f1s) - 1
        for i, lvl in enumerate(range(top, 1, -1)):
            f1, f2 = f1s[lvl], f2s[lvl]
            if flow is None:
                warped = f2
                corr_in = []
            else:
                ratio = f1.shape[3] / flow.shape[3]
                size = (f1.shape[2], f1.shape[3])
                flow = flow_ops.resize_bilinear(flow, size) * ratio
                up_feat = flow_ops.resize_bilinear(up_feat, size)
                warp = (flow_ops.warp_two_pass
                        if cfg.warp_backend == "two_pass" else flow_ops.warp)
                warped = warp(f2, flow.to(dt))
                corr_in = [up_feat.to(dt), flow.to(dt)]
            corr = _correlation_dispatch(
                f1.float(), warped.float(), cfg.search_range,
                corr_backend).to(dt)
            corr = _lrelu(corr)
            extra = []
            if cfg.occlusion_cue:
                occ = (f1.float() - warped.float()).abs().mean(
                    dim=1, keepdim=True).to(dt)
                extra = [occ]
            x = torch.cat([corr, f1] + corr_in + extra, dim=1)
            feat, up, res_flow = self.estimators[i](x)
            flow = res_flow if flow is None else flow + res_flow
            if lvl == 2 and self.context is not None:
                flow = self.context(feat, flow)
            flows.append(flow)
            up_feat = up
        full = flow_ops.resize_bilinear(flow, (h, w)) * (h / flow.shape[2])
        return full, flows[::-1]


def init_pwc_params(model: PWCNet, generator: torch.Generator | None = None
                    ) -> PWCNet:
    """Draw every parameter afresh as Flax initialises the JAX net:
    ``lecun_normal`` kernels from ``generator`` (the training CLI's
    ``--seed``), zero biases. The draws are not the JAX package's."""
    for m in model.modules():
        if isinstance(m, Conv):
            lecun_normal_(m.weight, generator)
            with torch.no_grad():
                m.bias.zero_()
    return model


def infer_flow_config(shapes: dict, base: FlowNetConfig | None = None
                      ) -> FlowNetConfig:
    """Architecture fields of a checkpoint's FlowNetConfig from its Flax
    kernel shapes (flat "params/Module_i/.../kernel" keys -> HWIO shape);
    non-architecture fields come from ``base``."""
    base = base or FlowNetConfig()

    def out_ch(key: str) -> int:
        return int(shapes[key][-1])

    def indices(prefix: str, field: str) -> list[int]:
        found = set()
        for k in shapes:
            if k.startswith(prefix + field + "_") and k.endswith("/kernel"):
                found.add(int(k[len(prefix + field + "_"):].split("/")[0]))
        return sorted(found)

    fp = "params/FeaturePyramid_0/"
    n_blocks = len(indices(fp, "ConvBlock"))
    if n_blocks % 2 or n_blocks < 6:
        raise ValueError(f"{n_blocks} pyramid convs: not a PWC-Net "
                         "checkpoint with >= 3 levels")
    feature_channels = tuple(
        out_ch(f"{fp}ConvBlock_{2 * i + 1}/Conv_0/kernel")
        for i in range(n_blocks // 2))
    in_channels = int(shapes[f"{fp}ConvBlock_0/Conv_0/kernel"][-2])
    est = "params/FlowEstimator_0/"
    estimator_channels = tuple(
        out_ch(f"{est}ConvBlock_{i}/Conv_0/kernel")
        for i in indices(est, "ConvBlock"))
    use_context = any(k.startswith("params/ContextNetwork_0/")
                      for k in shapes)
    context_channels = base.context_channels
    if use_context:
        ctx = indices("params/ContextNetwork_0/", "Conv")
        context_channels = tuple(
            out_ch(f"params/ContextNetwork_0/Conv_{i}/kernel")
            for i in ctx[:-1])
    corr_dim = (int(shapes[f"{est}ConvBlock_0/Conv_0/kernel"][-2])
                - feature_channels[-1])
    # One past an odd square: the occlusion cue's extra input channel.
    side = math.isqrt(corr_dim)
    if side * side == corr_dim and side % 2 == 1:
        occlusion_cue = False
    else:
        side = math.isqrt(corr_dim - 1)
        if side * side != corr_dim - 1 or side % 2 == 0:
            raise ValueError(f"estimator input width {corr_dim} is no "
                             "correlation window (+ occlusion cue)")
        occlusion_cue = True
    return dataclasses.replace(
        base,
        pyramid_levels=len(feature_channels),
        feature_channels=feature_channels,
        estimator_channels=estimator_channels,
        context_channels=context_channels,
        use_context_net=use_context,
        search_range=(side - 1) // 2,
        in_channels=in_channels,
        occlusion_cue=occlusion_cue,
    )
