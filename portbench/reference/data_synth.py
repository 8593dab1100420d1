"""Frozen copy of ``moving_object_detector_tpu_torch/train/data_synth.py``
at fc97bde (the photographs read from ``portbench/traffic``), the
benchmark's plain reference: it imports nothing of the port.

Synthetic optical-flow training data on the device (FlyingChairs-style),
the JAX package's ``train/data_synth.py`` in PyTorch.

Layered scenes: a textured background under K textured "objects", every
layer moving by its own random similarity map, rendered twice with the
analytic forward flow of the topmost layer at each pixel. Textures are
multi-octave value noise, cell-quantised blocks or (``real_frac``) crops
of the repository's real photographs; masks are soft ellipses or, in the
local-motion regime, rotated rectangles; img2 gets a photometric jitter
and both images sensor noise. Flow convention: img1(x) ~ img2(x +
flow(x)), the warp layer's contract (``ops/flow_ops.py``).

Generation is split in two. ``draw_pair`` takes every random number a
batch needs from one ``torch.Generator``, on that generator's device, as
unit uniforms, integers and normals. ``render_pair`` turns the draws into
images and flow with no randomness, every sample of the batch at once.
The JAX package draws from its PRNG keys, which a torch generator
cannot reproduce, so the tests hand both packages the same draws and
hold the renderers to each other. Images are (B, C, H, W) in [0, 1], flow
(B, 2, H, W) in pixels, the layout the port's net takes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import flow_ops
from .resize import resize_bilinear_hw

OCTAVES = 5
COLOR_OCTAVES = 3

# ---------------------------------------------------------------------------
# Unit draws onto ranges, as JAX's random uniform maps them
# ---------------------------------------------------------------------------


def _f32(x: float) -> float:
    return float(np.float32(x))


def _uniform(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """Unit draws ``u`` in [0, 1) onto [lo, hi) as JAX's random uniform
    maps its own: max(lo, u (hi - lo) + lo) in f32. ``lo`` / ``hi`` are
    Python floats (rounded to f32 first, their difference taken in f32,
    as JAX does) or f32 tensors that broadcast against ``u``."""
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        return torch.maximum(lo, u * (hi - lo) + lo)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp_min(u * float(hi32 - lo32) + float(lo32), float(lo32))


# ---------------------------------------------------------------------------
# Textures
# ---------------------------------------------------------------------------


def _octave_texture(grids, drop_u, cut, h: int, w: int) -> torch.Tensor:
    """Multi-octave value noise in [0, 1], (B, h, w): octave k's coarse
    unit grid (B, gh_k, gw_k) bilinearly upsampled, weighted 1 / 2^k and
    summed. With ``drop_u`` < 0.3 the ``cut`` coarsest octaves are
    dropped: fine-only textures teach "uninformative coarse level =>
    near-zero coarse flow"."""
    do_drop = drop_u < 0.3
    b = drop_u.shape[0]
    out = torch.zeros((b, h, w), dtype=torch.float32, device=drop_u.device)
    amp_total = torch.zeros((b,), dtype=torch.float32, device=drop_u.device)
    for k, grid in enumerate(grids):
        amp = torch.where(do_drop & (k < cut), 0.0, _f32(1.0 / (2 ** k)))
        out = out + amp[:, None, None] * resize_bilinear_hw(grid, (h, w), 1)
        amp_total = amp_total + amp
    return out / torch.clamp_min(amp_total, 1e-6)[:, None, None]


def _octave_grid_shapes(h: int, w: int, octaves: int):
    return [(max(2, h // (2 ** (octaves - k + 1))),
             max(2, w // (2 ** (octaves - k + 1)))) for k in range(octaves)]


def _smooth3(t: torch.Tensor) -> torch.Tensor:
    """Separable 3-tap [0.25, 0.5, 0.25] blur with edge padding of the
    last two dimensions."""
    p = torch.cat([t[..., :1, :], t, t[..., -1:, :]], dim=-2)
    t = 0.25 * p[..., :-2, :] + 0.5 * p[..., 1:-1, :] + 0.25 * p[..., 2:, :]
    p = torch.cat([t[..., :1], t, t[..., -1:]], dim=-1)
    return 0.25 * p[..., :-2] + 0.5 * p[..., 1:-1] + 0.25 * p[..., 2:]


def _cell_texture(grid_u, cell, blend_u, h: int, w: int) -> torch.Tensor:
    """Cell-quantised "blocky" texture, (B, h, w): values in [0.05, 0.95)
    nearest-upsampled by a per-sample integer cell size (2-8 px), blended
    ``blend_u`` toward a 3-tap blur. Covers sharp, piecewise-constant
    man-made imagery (tiles, checkerboards) that octave noise cannot."""
    grid = _uniform(grid_u, 0.05, 0.95)
    b, gh, gw = grid.shape
    dev = grid.device
    iy = torch.arange(h, device=dev)[None, :] // cell[:, None]
    ix = torch.arange(w, device=dev)[None, :] // cell[:, None]
    tex = grid.gather(1, iy[:, :, None].expand(b, h, gw))
    tex = tex.gather(2, ix[:, None, :].expand(b, h, w))
    s = blend_u[:, None, None]
    return (1.0 - s) * tex + s * _smooth3(tex)


# Real photographs (tests/fixtures/real_textures.npz, the held-out ones
# left out) tiled to a fixed canvas: crops and 2x zoom-outs sample natural
# image statistics at two scales.
_REAL_BANK_HW = (1024, 1920)
_real_bank_host = None
_real_bank_device: dict = {}


def _real_bank(device=None):
    """(N, 1024, 1920) f32 canvas of the training photographs on
    ``device`` (host numpy when None), loaded once; None without the
    fixture."""
    global _real_bank_host
    if _real_bank_host is None:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "traffic", "real_textures.npz")
        if not os.path.exists(path):
            _real_bank_host = False
        else:
            bh, bw = _REAL_BANK_HW
            canvases = []
            with np.load(path) as data:
                for k in data.files:
                    if k.startswith("heldout_"):
                        continue  # the held-out imagery tests' photos
                    img = data[k].astype(np.float32) / 255.0
                    ry = -(-bh // img.shape[0])
                    rx = -(-bw // img.shape[1])
                    canvases.append(np.tile(img, (ry, rx))[:bh, :bw])
            _real_bank_host = np.stack(canvases)
    if _real_bank_host is False:
        return None
    if device is None:
        return _real_bank_host
    key = str(torch.device(device))
    if key not in _real_bank_device:
        _real_bank_device[key] = torch.from_numpy(_real_bank_host).to(device)
    return _real_bank_device[key]


def _real_zoom(h: int, w: int) -> bool:
    bh, bw = _REAL_BANK_HW
    return 2 * h <= bh and 2 * w <= bw


def _real_texture(bank, d: dict, h: int, w: int) -> torch.Tensor:
    """(B, h, w) crops of the photographs ``d["index"]`` at (``y0``,
    ``x0``); a 2x zoomed-out view where ``zoom_u`` < 0.5 (when the canvas
    allows), flips, a gamma in exp([-0.4, 0.4)) and 15 % inversions."""
    zoom = _real_zoom(h, w)
    ch, cw = (2 * h, 2 * w) if zoom else (h, w)
    dev = bank.device
    rows = d["y0"][:, None] + torch.arange(ch, device=dev)[None]
    cols = d["x0"][:, None] + torch.arange(cw, device=dev)[None]
    crop = bank[d["index"][:, None, None], rows[:, :, None],
                cols[:, None, :]]
    if zoom:
        tex = torch.where((d["zoom_u"] < 0.5)[:, None, None],
                          resize_bilinear_hw(crop, (h, w), 1),
                          crop[:, :h, :w])
    else:
        tex = crop
    tex = torch.where((d["flip_lr_u"] < 0.5)[:, None, None],
                      tex.flip(2), tex)
    tex = torch.where((d["flip_ud_u"] < 0.5)[:, None, None],
                      tex.flip(1), tex)
    gamma = torch.exp(_uniform(d["gamma_u"], -0.4, 0.4))
    tex = flow_ops._clip(tex, 1e-4, 1.0) ** gamma[:, None, None]
    return torch.where((d["invert_u"] < 0.15)[:, None, None], 1.0 - tex, tex)


def _use_real(h: int, w: int, real_frac: float) -> bool:
    return real_frac > 0.0 and _real_bank() is not None and min(h, w) >= 8


def _any_texture(d: dict, h: int, w: int, real_frac: float = 0.0
                 ) -> torch.Tensor:
    """The texture sampler, (B, h, w): cell-quantised where ``family_u`` <
    0.35 (1 - real_frac), octave noise otherwise, and the real-photo crop
    where ``family_u`` >= 1 - real_frac (when the bank is there)."""
    u = d["family_u"][:, None, None]
    oc = d["octave"]
    base = torch.where(u < 0.35 * (1.0 - real_frac),
                       _cell_texture(*d["cell"], h, w),
                       _octave_texture(oc["grids"], oc["drop_u"],
                                       oc["cut"], h, w))
    if not _use_real(h, w, real_frac):
        return base
    bank = _real_bank(u.device)
    return torch.where(u >= 1.0 - real_frac,
                       _real_texture(bank, d["real"], h, w), base)


def _colorize(d: dict, gray: torch.Tensor) -> torch.Tensor:
    """(B, h, w) gray -> (B, 3, h, w) RGB: a global tint in [0.75, 1.25)
    and two smooth 3-octave chroma fields (red and blue)."""
    _, h, w = gray.shape
    tint = _uniform(d["tint_u"], 0.75, 1.25)
    m_r = _octave_texture(d["m_r"]["grids"], d["m_r"]["drop_u"],
                          d["m_r"]["cut"], h, w)
    m_b = _octave_texture(d["m_b"]["grids"], d["m_b"]["drop_u"],
                          d["m_b"]["cut"], h, w)
    mod = torch.stack([1.0 + 0.3 * (m_r - 0.5), torch.ones_like(gray),
                       1.0 + 0.3 * (m_b - 0.5)], dim=1)
    return flow_ops._clip(gray[:, None] * tint[:, :, None, None] * mod,
                          0.0, 1.0)


def _layer_texture(d: dict, h: int, w: int, real_frac: float,
                   channels: int) -> torch.Tensor:
    tex = _any_texture(d, h, w, real_frac)
    return _colorize(d["color"], tex) if channels == 3 else tex[:, None]


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def _rand_affine(d: dict, h: int, w: int, max_shift, max_rot,
                 max_log_scale):
    """Per-sample similarity maps phi: img1 coords -> img2 coords about
    the image centre, from unit draws and (B,) bounds: the linear part
    (B, 2, 2) on (x, y) and the translation (B, 2)."""
    theta = _uniform(d["theta_u"], -max_rot, max_rot)
    s = torch.exp(_uniform(d["scale_u"], -max_log_scale, max_log_scale))
    t = _uniform(d["shift_u"], -max_shift[:, None], max_shift[:, None])
    c, sn = torch.cos(theta), torch.sin(theta)
    lin = s[:, None, None] * torch.stack(
        [torch.stack([c, -sn], -1), torch.stack([sn, c], -1)], -2)
    cx, cy = _f32((w - 1) / 2.0), _f32((h - 1) / 2.0)
    lc = lin[:, :, 0] * cx + lin[:, :, 1] * cy  # lin @ center
    trans = torch.stack([cx + t[:, 0], cy + t[:, 1]], -1) - lc
    return lin, trans


def _apply_affine(lin: torch.Tensor, trans: torch.Tensor,
                  xy: torch.Tensor) -> torch.Tensor:
    """xy (B, h, w, 2) or (h, w, 2) as (x, y) -> phi(xy), (B, h, w, 2)."""
    l = lin[:, None, None]
    return (xy[..., 0:1] * l[..., 0] + xy[..., 1:2] * l[..., 1]
            + trans[:, None, None])


def _grid_xy(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) pixel coordinates as (x, y)."""
    x = torch.arange(w, dtype=torch.float32, device=device)
    y = torch.arange(h, dtype=torch.float32, device=device)
    return torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)],
                       -1)


def _invert_affine(lin: torch.Tensor, trans: torch.Tensor):
    """phi^-1 of (lin, trans): the 2 x 2 inverse in closed form (no
    device sync, unlike a checked ``linalg.inv``)."""
    a, b = lin[:, 0, 0], lin[:, 0, 1]
    c, d = lin[:, 1, 0], lin[:, 1, 1]
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], -1),
                       torch.stack([-c, a], -1)], -2) / det[:, None, None]
    itrans = -(inv[:, :, 0] * trans[:, :1] + inv[:, :, 1] * trans[:, 1:])
    return inv, itrans


def _mask_uv(xy, center, radii, angle):
    c = torch.cos(angle)[:, None, None]
    sn = torch.sin(angle)[:, None, None]
    rel = xy - center[:, None, None]
    u = (rel[..., 0] * c + rel[..., 1] * sn) / radii[:, None, None, 0]
    v = (-rel[..., 0] * sn + rel[..., 1] * c) / radii[:, None, None, 1]
    return u, v


def _ellipse_mask(xy, center, radii, angle, soft) -> torch.Tensor:
    """Soft ellipse indicator (B, h, w) at xy (B, h, w, 2)."""
    u, v = _mask_uv(xy, center, radii, angle)
    d = torch.sqrt(u * u + v * v + 1e-9)
    rmin = radii.min(-1).values[:, None, None]
    return torch.sigmoid((1.0 - d) * rmin / soft[:, None, None])


def _rect_mask(xy, center, radii, angle, soft) -> torch.Tensor:
    """Soft rotated-rectangle indicator (the Chebyshev analogue of the
    ellipse): hard straight silhouette edges, like real movers."""
    u, v = _mask_uv(xy, center, radii, angle)
    d = torch.maximum(u.abs(), v.abs())
    rmin = radii.min(-1).values[:, None, None]
    return torch.sigmoid((1.0 - d) * rmin / soft[:, None, None])


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


def _unit(gen, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def _randint(gen, lo: int, hi: int, b: int) -> torch.Tensor:
    return torch.randint(lo, hi, (b,), generator=gen, device=gen.device)


def _draw_octave(gen, b: int, h: int, w: int, octaves: int) -> dict:
    return {"grids": [_unit(gen, b, gh, gw)
                      for gh, gw in _octave_grid_shapes(h, w, octaves)],
            "drop_u": _unit(gen, b),
            "cut": _randint(gen, 1, max(2, octaves - 1), b)}


def _draw_texture(gen, b: int, h: int, w: int) -> dict:
    return {"family_u": _unit(gen, b),
            "octave": _draw_octave(gen, b, h, w, OCTAVES),
            "cell": (_unit(gen, b, h // 2 + 1, w // 2 + 1),
                     _randint(gen, 2, 9, b), _unit(gen, b))}


def _draw_real(gen, b: int, h: int, w: int) -> dict:
    n, bh, bw = _real_bank().shape
    ch, cw = (2 * h, 2 * w) if _real_zoom(h, w) else (h, w)
    return {"index": _randint(gen, 0, n, b),
            "y0": _randint(gen, 0, bh - ch + 1, b),
            "x0": _randint(gen, 0, bw - cw + 1, b),
            **{k: _unit(gen, b) for k in ("zoom_u", "flip_lr_u",
                                          "flip_ud_u", "gamma_u",
                                          "invert_u")}}


def _draw_color(gen, b: int, h: int, w: int) -> dict:
    return {"tint_u": _unit(gen, b, 3),
            "m_r": _draw_octave(gen, b, h, w, COLOR_OCTAVES),
            "m_b": _draw_octave(gen, b, h, w, COLOR_OCTAVES)}


def _draw_affine(gen, b: int) -> dict:
    return {"theta_u": _unit(gen, b), "scale_u": _unit(gen, b),
            "shift_u": _unit(gen, b, 2)}


def draw_pair(gen: torch.Generator, batch: int, h: int, w: int,
              n_objects: int = 4, real_frac: float = 0.0,
              local_motion_frac: float = 0.0, channels: int = 1) -> dict:
    """Every random number ``render_pair`` needs for ``batch`` scenes,
    drawn from ``gen`` on its device: unit uniforms ("..._u"), integers
    and the sensor noise's unit normals. The photographs' crops and the
    colour fields are drawn last, so one seed gives the same geometry
    with and without them, as one JAX key does."""
    b = batch
    objects = []
    for _ in range(n_objects):
        o = {"texture": _draw_texture(gen, b, h, w),
             "affine": _draw_affine(gen, b),
             "center_u": _unit(gen, b, 2), "radii_u": _unit(gen, b, 2),
             "angle_u": _unit(gen, b), "soft_u": _unit(gen, b)}
        if local_motion_frac > 0:
            o.update(pure_u=_unit(gen, b), pure_shift_u=_unit(gen, b, 2),
                     rect_u=_unit(gen, b))
        objects.append(o)
    draws = {
        "mag_u": _unit(gen, b), "static_u": _unit(gen, b),
        "local_u": _unit(gen, b), "bg_scale_u": _unit(gen, b),
        "log_mag_u": _unit(gen, b),
        "background": {"texture": _draw_texture(gen, b, h, w),
                       "affine": _draw_affine(gen, b)},
        "objects": objects,
        "gain_u": _unit(gen, b), "bias_u": _unit(gen, b),
        "noise": torch.randn((b, 2, channels, h, w), generator=gen,
                             device=gen.device),
    }
    layers = [draws["background"]] + objects
    for layer in layers if _use_real(h, w, real_frac) else ():
        layer["texture"]["real"] = _draw_real(gen, b, h, w)
    for layer in layers if channels == 3 else ():
        layer["texture"]["color"] = _draw_color(gen, b, h, w)
    return draws


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def render_pair(draws: dict, h: int, w: int, max_shift: float = 24.0,
                bg_max_shift: float = 10.0, real_frac: float = 0.0,
                local_motion_frac: float = 0.0, channels: int = 1):
    """The scenes of ``draws``: (img1, img2, flow), (B, C, h, w) images in
    [0, 1] and (B, 2, h, w) forward flow, with no randomness.

    Motion: a per-sample magnitude ``mag`` ~ U[0, 1) (exactly 0 for 10 %
    of samples) scales every bound, so small and zero motion stay in the
    distribution. ``local_motion_frac`` of samples come from the
    local-motion regime: the background's bounds shrink by U[0, 0.2),
    the objects' magnitude is log-uniform in [0.04, 1) of ``max_shift``,
    half the objects translate purely and half are rectangles."""
    local = local_motion_frac > 0
    is_local = draws["local_u"] < local_motion_frac if local else \
        torch.zeros_like(draws["local_u"], dtype=torch.bool)
    bg_scale = (torch.where(is_local, draws["bg_scale_u"] * 0.2, 1.0)
                if local else 1.0)
    mag = torch.where(draws["static_u"] < 0.1, 0.0, draws["mag_u"])
    log_mag = _uniform(draws["log_mag_u"], float(np.log(np.float32(0.04))),
                       0.0)
    obj_mag = torch.where(is_local, torch.exp(log_mag), mag)
    bg_mag = mag * bg_scale
    dev = mag.device
    xy = _grid_xy(h, w, dev)

    def warp(tex, coords):
        return flow_ops.warp(tex, (coords - xy).permute(0, 3, 1, 2))

    bg = draws["background"]
    bg_tex = _layer_texture(bg["texture"], h, w, real_frac, channels)
    bg_lin, bg_trans = _rand_affine(bg["affine"], h, w, bg_mag * bg_max_shift,
                                    bg_mag * 0.05, bg_mag * 0.05)
    img1 = bg_tex
    flow = _apply_affine(bg_lin, bg_trans, xy) - xy
    # img2(y) = img1(phi^-1(y)): a backward warp by phi^-1(y) - y.
    img2 = warp(bg_tex, _apply_affine(*_invert_affine(bg_lin, bg_trans), xy))

    min_dim = min(h, w)
    eye = torch.eye(2, device=dev)
    for o in draws["objects"]:
        tex = _layer_texture(o["texture"], h, w, real_frac, channels)
        lin, trans = _rand_affine(o["affine"], h, w, obj_mag * max_shift,
                                  obj_mag * 0.3, obj_mag * 0.15)
        if local:
            pure = is_local & (o["pure_u"] < 0.5)
            bound = (obj_mag * max_shift)[:, None]
            t_pure = _uniform(o["pure_shift_u"], -bound, bound)
            lin = torch.where(pure[:, None, None], eye, lin)
            trans = torch.where(pure[:, None], t_pure, trans)
            use_rect = is_local & (o["rect_u"] < 0.5)
        cu = o["center_u"]
        center = torch.stack([_uniform(cu[:, 0], 0.15 * w, 0.85 * w),
                              _uniform(cu[:, 1], 0.15 * h, 0.85 * h)], -1)
        radii = _uniform(o["radii_u"], 0.06 * min_dim, 0.22 * min_dim)
        angle = _uniform(o["angle_u"], 0.0, 3.14159)
        soft = _uniform(o["soft_u"], 0.25, 1.5)

        def mask(at):
            ell = _ellipse_mask(at, center, radii, angle, soft)
            if not local:
                return ell
            rect = _rect_mask(at, center, radii, angle, soft)
            return torch.where(use_rect[:, None, None], rect, ell)

        m1 = mask(xy)
        obj_flow = _apply_affine(lin, trans, xy) - xy
        img1 = m1[:, None] * tex + (1.0 - m1[:, None]) * img1
        flow = m1[..., None] * obj_flow + (1.0 - m1[..., None]) * flow
        # In img2 the object (texture and mask) lives at phi(object):
        # both are evaluated at phi^-1(y).
        src = _apply_affine(*_invert_affine(lin, trans), xy)
        m2 = mask(src)
        img2 = m2[:, None] * warp(tex, src) + (1.0 - m2[:, None]) * img2

    gain = _uniform(draws["gain_u"], 0.85, 1.15)[:, None, None, None]
    bias = _uniform(draws["bias_u"], -0.08, 0.08)[:, None, None, None]
    noise = 0.015 * draws["noise"]
    img2 = flow_ops._clip(img2 * gain + bias + noise[:, 1], 0.0, 1.0)
    img1 = flow_ops._clip(img1 + noise[:, 0], 0.0, 1.0)
    return img1, img2, flow.permute(0, 3, 1, 2)


def downsample_scale2(img1, img2, flow, h: int, w: int):
    """A (2h, 2w) scene through the ``flow_input_scale=2`` serving
    downsample (antialiased bilinear), flow halved."""
    return (resize_bilinear_hw(img1, (h, w), 2),
            resize_bilinear_hw(img2, (h, w), 2),
            resize_bilinear_hw(flow, (h, w), 2) * 0.5)


def generate_pair(gen: torch.Generator, batch: int, h: int, w: int,
                  n_objects: int = 4, max_shift: float = 24.0,
                  bg_max_shift: float = 10.0, real_frac: float = 0.0,
                  local_motion_frac: float = 0.0, channels: int = 1):
    """``batch`` training examples on ``gen``'s device: (img1, img2, flow),
    (B, C, h, w) and (B, 2, h, w). ``channels=3`` colourises every texture
    with synthetic chroma (RGB flow nets)."""
    draws = draw_pair(gen, batch, h, w, n_objects, real_frac,
                      local_motion_frac, channels)
    return render_pair(draws, h, w, max_shift, bg_max_shift, real_frac,
                       local_motion_frac, channels)


def generate_pair_scale2(gen: torch.Generator, batch: int, h: int, w: int,
                         n_objects: int = 4, max_shift: float = 24.0,
                         bg_max_shift: float = 10.0, real_frac: float = 0.0,
                         local_motion_frac: float = 0.0, channels: int = 1):
    """Examples of the ``flow_input_scale=2`` serving distribution: scenes
    at (2h, 2w) with doubled motion bounds, downsampled as the serving
    path does, flow halved. ``max_shift`` bounds are in output pixels."""
    img1, img2, flow = generate_pair(
        gen, batch, 2 * h, 2 * w, n_objects, 2.0 * max_shift,
        2.0 * bg_max_shift, real_frac, local_motion_frac, channels)
    return downsample_scale2(img1, img2, flow, h, w)


def generate_batch(gen: torch.Generator, batch: int, h: int, w: int,
                   n_objects: int = 4, max_shift: float = 24.0,
                   bg_max_shift: float = 10.0, downsample_frac: float = 0.0,
                   real_frac: float = 0.0, local_motion_frac: float = 0.0,
                   channels: int = 1) -> dict:
    """dict(img1, img2, flow) of ``batch`` examples made on ``gen``'s
    device, the training loop's batch source. The last
    round(batch * downsample_frac) come from ``generate_pair_scale2``."""
    n_ds = int(round(batch * float(downsample_frac)))
    parts = []
    args = (n_objects, max_shift, bg_max_shift, real_frac,
            local_motion_frac, channels)
    if batch - n_ds > 0:
        parts.append(generate_pair(gen, batch - n_ds, h, w, *args))
    if n_ds > 0:
        parts.append(generate_pair_scale2(gen, n_ds, h, w, *args))
    img1, img2, flow = (parts[0] if len(parts) == 1 else
                        tuple(torch.cat(x, 0) for x in zip(*parts)))
    return {"img1": img1, "img2": img2, "flow": flow}


__all__ = ["draw_pair", "render_pair", "downsample_scale2", "generate_pair",
           "generate_pair_scale2", "generate_batch"]
