"""Integral-channel-features toolkit (the JAX package's ``alg/icf.py``,
kkl/cvk/*).

Channel extraction (HSV, LUV, oriented-gradient histograms), integral
images and normalized box filters (the ICF building blocks of
icf_channel_extractor.hpp / icf_channel_bank.hpp /
icf_integral_filter.hpp), plus the cvutils.hpp palette / rect helpers.

Images are (H, W) or (H, W, 3) f32 tensors in [0, 1]; extractors return
(C, H, W) channel stacks; box filters take fractional ROIs, so a feature
definition is resolution-independent like IntegralFilter
(icf_integral_filter.hpp:13-27), and a batch of ROIs evaluates in one
4-corner gather. Everything runs on the device of its input. The
gradient channels keep float magnitudes instead of the reference's 8-bit
quantization (icf_channel_extractor.hpp:128-148).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Color channel extractors (icf_channel_extractor.hpp)
# ---------------------------------------------------------------------------


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """BT.601 luma, OpenCV's BGR2GRAY weights."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def extract_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(3, H, W) hue / sat / val channels (ChannelExtractorHSV,
    icf_channel_extractor.hpp:42-64) in OpenCV's 8-bit ranges: H in
    [0, 180), S and V in [0, 255]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    one = torch.ones_like(c)
    safe_c = torch.where(c > 0, c, one)
    h = torch.where(v == r, (g - b) / safe_c,
                    torch.where(v == g, 2.0 + (b - r) / safe_c,
                                4.0 + (r - g) / safe_c))
    h = torch.where(c > 0, torch.remainder(h * 60.0, 360.0),
                    torch.zeros_like(h))
    s = torch.where(v > 0, c / torch.where(v > 0, v, one),
                    torch.zeros_like(c))
    return torch.stack([h / 2.0, s * 255.0, v * 255.0])


def extract_luv(rgb: torch.Tensor) -> torch.Tensor:
    """(3, H, W) CIE L*u*v* channels (ChannelExtractorLUV,
    icf_channel_extractor.hpp:69-91), with OpenCV's 8-bit scaling
    (L*255/100, (u+134)*255/354, (v+140)*255/262)."""
    rgb_lin = torch.where(rgb <= 0.04045, rgb / 12.92,
                          ((rgb + 0.055) / 1.055) ** 2.4)
    r, g, b = rgb_lin[..., 0], rgb_lin[..., 1], rgb_lin[..., 2]
    x = 0.412453 * r + 0.357580 * g + 0.180423 * b
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = 0.019334 * r + 0.119193 * g + 0.950227 * b
    # cube root of y > 0.008856 only, so the power's sign rule never bites
    l_ = torch.where(y > 0.008856, 116.0 * y.abs().pow(1.0 / 3.0) - 16.0,
                     903.3 * y)
    denom = x + 15.0 * y + 3.0 * z
    zero = torch.zeros_like(denom)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    u_p = torch.where(denom > 0, 4.0 * x / safe, zero)
    v_p = torch.where(denom > 0, 9.0 * y / safe, zero)
    # white point (D65): u'n = 0.19793943, v'n = 0.46831096
    u = 13.0 * l_ * (u_p - 0.19793943)
    v = 13.0 * l_ * (v_p - 0.46831096)
    return torch.stack([l_ * 255.0 / 100.0, (u + 134.0) * 255.0 / 354.0,
                        (v + 140.0) * 255.0 / 262.0])


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _sobel(gray: torch.Tensor):
    """3x3 Sobel dx, dy, replicate-padded (OpenCV's default
    BORDER_REFLECT_101 differs only on the edge pixels, which rarely feed
    ICF features)."""
    h, w = gray.shape
    g = F.pad(gray[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    windows = torch.stack([g[dy:dy + h, dx:dx + w] for dy in range(3)
                           for dx in range(3)], dim=-1)
    kx = torch.tensor(_SOBEL_X, device=gray.device)
    return windows @ kx.reshape(-1), windows @ kx.T.reshape(-1)


def extract_grads(gray: torch.Tensor, n_bins: int = 6) -> torch.Tensor:
    """(n_bins + 1, H, W) oriented-gradient channels
    (ChannelExtractorGrads, icf_channel_extractor.hpp:96-153): channel k
    holds the gradient magnitude where the orientation falls in bin k of
    [0, pi) (the reference folds [pi, 2pi) onto [0, pi)), and the last
    channel is the unbinned magnitude."""
    dx, dy = _sobel(gray)
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.remainder(torch.atan2(dy, dx), 2.0 * math.pi)
    idx = torch.remainder((ang * (n_bins / math.pi)).to(torch.int32),
                          n_bins)
    bins = torch.arange(n_bins, device=gray.device)[:, None, None]
    binned = (idx[None] == bins) * mag[None]
    return torch.cat([binned, mag[None]], dim=0)


def channel_bank(
        extractors: Sequence[Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor]]
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Compose extractors into one (C_total, H, W) stack (ChannelBank,
    icf_channel_bank.hpp:16-56). Each extractor takes (rgb, gray)."""

    def extract(rgb: torch.Tensor) -> torch.Tensor:
        gray = rgb_to_gray(rgb)
        return torch.cat([e(rgb, gray) for e in extractors], dim=0)

    return extract


def default_channel_bank() -> Callable[[torch.Tensor], torch.Tensor]:
    """HSV + LUV + 6-bin gradients: the standard 13-channel ICF bank."""
    return channel_bank([
        lambda rgb, gray: extract_hsv(rgb),
        lambda rgb, gray: extract_luv(rgb),
        lambda rgb, gray: extract_grads(gray),
    ])


# ---------------------------------------------------------------------------
# Integral images and box filters (icf_integral_filter.hpp)
# ---------------------------------------------------------------------------


def integral_image(img: torch.Tensor) -> torch.Tensor:
    """Inclusive 2D prefix sum over the LAST TWO axes (leading channel
    axes go along)."""
    return torch.cumsum(torch.cumsum(img, dim=-2), dim=-1)


def box_filter(integral: torch.Tensor, tl, size) -> torch.Tensor:
    """Mean of pixel values in fractional ROIs via the 4-corner identity
    (IntegralFilter::filter, icf_integral_filter.hpp:35-49): ``tl`` and
    ``size`` (..., 2) in [0, 1] image fractions (x, y); pixel rects with
    width or height <= 2 give 0, as in the reference. ``integral`` is a
    (*C, H, W) stack; the result is (*C, *ROI)."""
    h, w = integral.shape[-2], integral.shape[-1]
    dev = integral.device
    tl = torch.as_tensor(tl, dtype=torch.float32, device=dev)
    size = torch.as_tensor(size, dtype=torch.float32, device=dev)
    x0 = (tl[..., 0] * w).to(torch.int32)
    y0 = (tl[..., 1] * h).to(torch.int32)
    rw = (size[..., 0] * w).to(torch.int32)
    rh = (size[..., 1] * h).to(torch.int32)

    def corner(y, x):
        ok = (y >= 0) & (x >= 0)
        val = integral[..., y.clamp(0, h - 1).long(),
                       x.clamp(0, w - 1).long()]
        return torch.where(ok, val, torch.zeros_like(val))

    a = corner(y0 - 1, x0 - 1)
    c = corner(y0 - 1, x0 - 1 + rw)
    b = corner(y0 - 1 + rh, x0 - 1)
    d = corner(y0 - 1 + rh, x0 - 1 + rw)
    mean = (d - b - c + a) / (rw * rh).to(torch.float32)
    return torch.where((rw <= 2) | (rh <= 2), torch.zeros_like(mean), mean)


def box_filter_bank(integral: torch.Tensor, tls, sizes) -> torch.Tensor:
    """N fractional ROIs ((N, 2) each) over a (..., H, W) integral stack
    in one gather -> (N, ...) feature responses: the whole ICF feature
    vector of a window in one call."""
    return box_filter(integral, tls, sizes).movedim(-1, 0)


# ---------------------------------------------------------------------------
# cvutils.hpp helpers (host-side)
# ---------------------------------------------------------------------------


def create_color_palette(n: int, scale: float = 255.0) -> np.ndarray:
    """(n, 3) RGB palette of evenly spread hues at s = v = 220
    (cvutils.hpp:10-25); host-side helper for visualization."""
    h = (180.0 / (n + 1)) * np.arange(n) * 2.0  # OpenCV H*2 = degrees
    s = np.full(n, 220.0 / 255.0)
    v = np.full(n, 220.0 / 255.0)
    c = v * s
    hp = h / 60.0
    xcomp = c * (1.0 - np.abs(np.mod(hp, 2.0) - 1.0))
    zeros = np.zeros(n)
    sector = np.floor(hp).astype(int) % 6
    rgb_opts = np.stack([
        np.stack([c, xcomp, zeros], 1),
        np.stack([xcomp, c, zeros], 1),
        np.stack([zeros, c, xcomp], 1),
        np.stack([zeros, xcomp, c], 1),
        np.stack([xcomp, zeros, c], 1),
        np.stack([c, zeros, xcomp], 1),
    ], axis=0)
    rgb = rgb_opts[sector, np.arange(n)] + (v - c)[:, None]
    return rgb * scale


def clip_roi(rect, size):
    """Clamp (x, y, w, h) to (W, H) bounds (cvutils.hpp:27-33)."""
    x, y, w, h = rect
    width, height = size
    left, top = max(0, x), max(0, y)
    right, bottom = min(width, x + w), min(height, y + h)
    return (left, top, right - left, bottom - top)


def enlarge_rect(rect, scale: float):
    """Scale a rect about its center (cvutils.hpp:35-38)."""
    x, y, w, h = rect
    d = (scale - 1.0) / 2.0
    return (x - w * d, y - h * d, w * scale, h * scale)


def shift_rect(rect, pt):
    """Translate a rect (cvutils.hpp:40-42)."""
    x, y, w, h = rect
    return (x + pt[0], y + pt[1], w, h)
