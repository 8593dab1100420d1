"""The port's synthetic flow data (``train/data_synth.py``) against the JAX
package's.

``jax.random`` cannot be reproduced by a ``torch.Generator``, so parity
is held where it can be:

* rendering: ``_draws`` repeats ``generate_pair``'s key splits
  (``data_synth.py:300-345, 361-400, 424-432``) and takes every random
  number the JAX generator takes from its keys; the port's deterministic
  helpers and its ``render_pair`` turn those draws into the same
  textures, maps, masks, images and flow. Each helper within 1e-6 of
  max(1, its largest |value|); whole images within 5e-6 (f32 sums of the
  resize and warp in other orders, through up to five layers), flow
  within 4 f32 ulps of the largest coordinate (a flow is the difference
  of two coordinates near max(h, w));
* distribution: the assertions of ``tests/test_data_synth.py`` hold for
  the port's own generator;
* ``synthetic_flow_batch`` (numpy) equals the JAX package's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu.train import data_synth as jds
from moving_object_detector_tpu.train.flow_trainer import (
    synthetic_flow_batch as j_roll_batch,
)
from moving_object_detector_tpu_torch.ops import flow_ops as tflow
from moving_object_detector_tpu_torch.train import data_synth as tds
from moving_object_detector_tpu_torch.train.flow_trainer import (
    synthetic_flow_batch as t_roll_batch,
)

TOL_HELPER = 1e-6
TOL_IMG = 5e-6


def _tol_xy(h, w):
    return 4 * float(np.spacing(np.float32(max(h, w))))


# --- JAX keys -> the port's draws -------------------------------------------

def _u(key, shape=()):
    return jax.random.uniform(key, shape)


def _ri(key, lo, hi):
    return jax.random.randint(key, (), lo, hi)


def _octave(key, h, w, octaves):
    keys = jax.random.split(key, octaves + 1)
    drop, cut = jax.random.split(keys[octaves])
    return {"grids": [_u(keys[k], s) for k, s in enumerate(
                tds._octave_grid_shapes(h, w, octaves))],
            "drop_u": _u(drop), "cut": _ri(cut, 1, max(2, octaves - 1))}


def _texture(key, h, w, real_frac, channels):
    kp, ko, kc, kr = jax.random.split(key, 4)
    kg, kcell, ks = jax.random.split(kc, 3)
    d = {"family_u": _u(kp), "octave": _octave(ko, h, w, 5),
         "cell": (_u(kg, (h // 2 + 1, w // 2 + 1)), _ri(kcell, 2, 9),
                  _u(ks))}
    if tds._use_real(h, w, real_frac):
        n, bh, bw = tds._real_bank().shape
        ch, cw = (2 * h, 2 * w) if tds._real_zoom(h, w) else (h, w)
        ki, ky, kx, kz, kfl, kfu, kgm, kv = jax.random.split(kr, 8)
        d["real"] = {"index": _ri(ki, 0, n), "y0": _ri(ky, 0, bh - ch + 1),
                     "x0": _ri(kx, 0, bw - cw + 1), "zoom_u": _u(kz),
                     "flip_lr_u": _u(kfl), "flip_ud_u": _u(kfu),
                     "gamma_u": _u(kgm), "invert_u": _u(kv)}
    if channels == 3:
        kt, ks1, ks2 = jax.random.split(jax.random.fold_in(key, 17), 3)
        d["color"] = {"tint_u": _u(kt, (3,)), "m_r": _octave(ks1, h, w, 3),
                      "m_b": _octave(ks2, h, w, 3)}
    return d


def _affine(key):
    k1, k2, k3 = jax.random.split(key, 3)
    return {"theta_u": _u(k1), "scale_u": _u(k2), "shift_u": _u(k3, (2,))}


def _draws_one(key, h, w, n_objects=4, real_frac=0.0, local=0.0,
               channels=1):
    keys = jax.random.split(key, 5 + 3 * n_objects)
    if local > 0:
        kmag, kstat, klm, kbg2 = jax.random.split(keys[4], 4)
        local_u, bg_u = _u(klm), _u(kbg2)
    else:
        kmag, kstat = jax.random.split(keys[4])
        local_u = bg_u = np.float32(0.5)  # not read
    objects = []
    for i in range(n_objects):
        kt, kp, km = keys[5 + 3 * i: 8 + 3 * i]
        pk = jax.random.split(km, 7 if local > 0 else 4)
        o = {"texture": _texture(kt, h, w, real_frac, channels),
             "affine": _affine(kp), "center_u": _u(pk[0], (2,)),
             "radii_u": _u(pk[1], (2,)), "angle_u": _u(pk[2]),
             "soft_u": _u(pk[3])}
        if local > 0:
            o.update(pure_u=_u(pk[4]), pure_shift_u=_u(pk[5], (2,)),
                     rect_u=_u(pk[6]))
        objects.append(o)
    jk1, jk2 = jax.random.split(keys[2])
    shape = (h, w, 2) if channels == 1 else (h, w, 2, channels)
    noise = jax.random.normal(keys[3], shape)
    noise = noise[..., None] if channels == 1 else noise
    return {"mag_u": _u(kmag), "static_u": _u(kstat), "local_u": local_u,
            "bg_scale_u": bg_u, "log_mag_u": _u(jax.random.fold_in(kmag, 1)),
            "background": {"texture": _texture(keys[0], h, w, real_frac,
                                               channels),
                           "affine": _affine(keys[1])},
            "objects": objects, "gain_u": _u(jk1), "bias_u": _u(jk2),
            "noise": noise.transpose(2, 3, 0, 1)}


def _stack(items):
    """Per-sample draws -> one batch of tensors."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([x[k] for x in items]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack(list(x)) for x in zip(*items))
    arr = np.stack([np.asarray(x) for x in items])
    t = torch.from_numpy(arr)
    return t.long() if arr.dtype.kind in "iu" else t.float()


def _draws(keys, h, w, **kw):
    return _stack([_draws_one(k, h, w, **kw) for k in keys])


# --- the deterministic helpers ----------------------------------------------

KEY = jax.random.PRNGKey(5)
H, W = 40, 56


def _tex_draw(real_frac=0.0, channels=1):
    return _stack([_texture(KEY, H, W, real_frac, channels)])


def _xy():
    return tds._grid_xy(H, W, "cpu")


def _affine_draw():
    return _stack([_affine(KEY)])


BOUNDS = (np.float32(6.0), np.float32(0.2), np.float32(0.1))


def _port_affine():
    b = [torch.tensor([x]) for x in BOUNDS]
    return tds._rand_affine(_affine_draw(), H, W, *b)


def _jax_affine():
    return jds._rand_affine(KEY, H, W, *(jnp.float32(x) for x in BOUNDS))


MASK_ARGS = (np.array([20.5, 17.25], np.float32),
             np.array([9.0, 6.5], np.float32), np.float32(0.7),
             np.float32(0.6))


def _mask_case(name):
    def run():
        xy = _xy()
        p = getattr(tds, name)(xy, *(torch.tensor(np.atleast_1d(a))[None]
                                     if np.ndim(a) else torch.tensor([a])
                                     for a in MASK_ARGS))
        j = getattr(jds, name)(jds._grid_xy(H, W), *map(jnp.asarray,
                                                       MASK_ARGS))
        return p[0], j
    return run


def _tex_case(real_frac):
    def run():
        p = tds._any_texture(_tex_draw(real_frac), H, W, real_frac)[0]
        return p, jds._any_texture(KEY, H, W, real_frac)
    return run


def _octave_case():
    d = _stack([_octave(KEY, H, W, 5)])
    return (tds._octave_texture(d["grids"], d["drop_u"], d["cut"], H, W)[0],
            jds._octave_texture(KEY, H, W))


def _cell_case():
    kg, kc, ks = jax.random.split(KEY, 3)
    d = _stack([(_u(kg, (H // 2 + 1, W // 2 + 1)), _ri(kc, 2, 9), _u(ks))])
    return tds._cell_texture(*d, H, W)[0], jds._cell_texture(KEY, H, W)


def _smooth_case():
    t = np.random.default_rng(1).random((H, W), np.float32)
    return tds._smooth3(torch.from_numpy(t)), jds._smooth3(jnp.asarray(t))


def _real_case():
    ki = jax.random.fold_in(KEY, 3)
    d = _stack([_texture(ki, H, W, 1.0, 1)])["real"]
    return (tds._real_texture(torch.from_numpy(tds._real_bank()), d, H,
                              W)[0],
            jds._real_texture(jax.random.split(ki, 4)[3], H, W))


def _colorize_case():
    gray = np.random.default_rng(2).random((H, W), np.float32)
    d = _tex_draw(channels=3)["color"]
    return (tds._colorize(d, torch.from_numpy(gray)[None])[0].permute(
                1, 2, 0),
            jds._colorize(jax.random.fold_in(KEY, 17), jnp.asarray(gray)))


def _rand_affine_case():
    lin, trans = _port_affine()
    jl, jt = _jax_affine()
    return (torch.cat([lin[0].flatten(), trans[0]]),
            jnp.concatenate([jl.ravel(), jt]))


def _apply_case():
    lin, trans = _port_affine()
    jl, jt = _jax_affine()
    return (tds._apply_affine(lin, trans, _xy())[0],
            jds._apply_affine(jl, jt, jds._grid_xy(H, W)))


def _invert_case():
    lin, trans = tds._invert_affine(*_port_affine())
    jl, jt = jds._invert_affine(*_jax_affine())
    return (torch.cat([lin[0].flatten(), trans[0]]),
            jnp.concatenate([jl.ravel(), jt]))


HELPERS = {
    "octave_texture": _octave_case,
    "smooth3": _smooth_case,
    "cell_texture": _cell_case,
    "real_texture": _real_case,
    "any_texture": _tex_case(0.0),
    "any_texture_real": _tex_case(0.6),
    "colorize": _colorize_case,
    "rand_affine": _rand_affine_case,
    "apply_affine": _apply_case,
    "grid_xy": lambda: (_xy(), jds._grid_xy(H, W)),
    "invert_affine": _invert_case,
    "ellipse_mask": _mask_case("_ellipse_mask"),
    "rect_mask": _mask_case("_rect_mask"),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helpers_equal_jax_for_the_same_draws(name):
    """Within TOL_HELPER of max(1, the largest |value|): absolute for
    textures and masks in [0, 1], relative for coordinates."""
    port, ref = HELPERS[name]()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    tol = TOL_HELPER * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=tol)


# --- the renderer -----------------------------------------------------------

RENDER_CASES = {  # name: (h, w, generate_pair's static arguments)
    "gray": (48, 64, dict()),
    "gray_local": (48, 64, dict(local=1.0)),
    "rgb_local": (48, 64, dict(local=0.5, channels=3)),
    "real_rgb": (40, 48, dict(n_objects=2, real_frac=0.5, channels=3)),
}


def _jax_pair(fn, key, h, w, kw, **extra):
    return fn(key, h, w, n_objects=kw.get("n_objects", 4),
              real_frac=kw.get("real_frac", 0.0),
              local_motion_frac=kw.get("local", 0.0),
              channels=kw.get("channels", 1), **extra)


def _render(draws, h, w, kw, max_shift=24.0, bg_max_shift=10.0):
    return tds.render_pair(draws, h, w, max_shift, bg_max_shift,
                           kw.get("real_frac", 0.0), kw.get("local", 0.0),
                           kw.get("channels", 1))


def _check_pair(port, ref, b, h, w):
    for x, y, tol in zip(port, ref, (TOL_IMG, TOL_IMG, _tol_xy(h, w))):
        np.testing.assert_allclose(x[b].numpy().transpose(1, 2, 0),
                                   np.asarray(y), rtol=0, atol=tol)


@pytest.mark.parametrize("name", sorted(RENDER_CASES))
def test_render_equals_generate_pair_for_the_same_draws(name):
    h, w, kw = RENDER_CASES[name]
    keys = [jax.random.PRNGKey(s) for s in (3, 12)]
    port = _render(_draws(keys, h, w, **kw), h, w, kw)
    for b, key in enumerate(keys):
        _check_pair(port, _jax_pair(jds.generate_pair, key, h, w, kw), b, h,
                    w)


def test_scale2_render_equals_generate_pair_scale2():
    h, w, kw = 24, 40, dict(local=0.5)
    keys = [jax.random.PRNGKey(s) for s in (4, 9)]
    big = _render(_draws(keys, 2 * h, 2 * w, **kw), 2 * h, 2 * w, kw,
                  max_shift=2.0 * 12.0, bg_max_shift=2.0 * 10.0)
    port = tds.downsample_scale2(*big, h, w)
    for b, key in enumerate(keys):
        ref = _jax_pair(jds.generate_pair_scale2, key, h, w, kw,
                        max_shift=12.0)
        _check_pair(port, ref, b, 2 * h, 2 * w)


def test_roll_batch_equals_jax_exactly():
    port = t_roll_batch(np.random.default_rng(4), 3, 16, 24)
    ref = j_roll_batch(np.random.default_rng(4), 3, 16, 24)
    for k in ("img1", "img2", "flow"):
        assert port[k].dtype == torch.float32
        np.testing.assert_array_equal(port[k].numpy(),
                                      np.asarray(ref[k]).transpose(0, 3, 1, 2))


# --- tests/test_data_synth.py's assertions on the port's generator ----------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_shapes_and_ranges():
    img1, img2, flow = tds.generate_pair(_gen(0), 1, 96, 160)
    assert img1.shape == (1, 1, 96, 160) and img2.shape == (1, 1, 96, 160)
    assert flow.shape == (1, 2, 96, 160)
    for img in (img1, img2):
        assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
    mag = torch.sqrt(torch.sum(flow ** 2, dim=1))
    assert 1.0 < float(mag.max()) < 120.0


def test_photometric_consistency():
    img1, img2, flow = tds.generate_pair(_gen(3), 1, 128, 192)
    err = (tflow.warp(img2, flow) - img1).abs()[0, 0].numpy()
    interior = err[16:-16, 16:-16]
    assert np.median(interior) < 0.06, np.median(interior)
    assert (interior < 0.15).mean() > 0.75, (interior < 0.15).mean()


def test_batch_and_determinism():
    b1 = tds.generate_batch(_gen(7), 3, 64, 96)
    b2 = tds.generate_batch(_gen(7), 3, 64, 96)
    assert b1["img1"].shape == (3, 1, 64, 96)
    assert b1["flow"].shape == (3, 2, 64, 96)
    assert torch.equal(b1["img2"], b2["img2"])
    assert float((b1["img1"][0] - b1["img1"][1]).abs().max()) > 0.05


def test_texture_family_includes_sharp_cell_textures():
    b = tds.generate_batch(_gen(11), 32, 64, 96)
    gx = b["img1"][:, 0].diff(dim=2).abs().mean(dim=(1, 2)).numpy()
    assert gx.max() > 3.0 * gx.min(), gx
    assert (gx > 0.02).any(), gx
    assert (gx < 0.02).any(), gx


def test_magnitude_mixture_keeps_static_scenes():
    b = tds.generate_batch(_gen(123), 64, 64, 96, max_shift=48.0,
                           bg_max_shift=20.0)
    peak = b["flow"].abs().amax(dim=(1, 2, 3)).numpy()
    assert (peak < 0.1).mean() >= 0.03, peak.min()
    assert (peak < 8.0).mean() >= 0.2
    assert peak.max() > 24.0


def test_scale2_samples_match_the_serving_downsample():
    """The port's scale-2 examples are its serving downsample (the
    pipeline's ``resize_image``, antialiased) of a 2x scene, flow
    halved."""
    from moving_object_detector_tpu_torch.ops.resize import resize_image

    h, w = 48, 80
    i1, _, fl = tds.generate_pair_scale2(_gen(3), 1, h, w, max_shift=12.0)
    ri1, _, rfl = tds.generate_pair(_gen(3), 1, 2 * h, 2 * w, 4, 24.0, 20.0)
    exp1 = resize_image(ri1[0, 0], (h, w))
    expf = resize_image(rfl[0].permute(1, 2, 0), (h, w)) * 0.5
    np.testing.assert_allclose(i1[0, 0].numpy(), exp1.numpy(), atol=1e-6)
    np.testing.assert_allclose(fl[0].permute(1, 2, 0).numpy(), expf.numpy(),
                               atol=1e-6)
    assert i1.shape == (1, 1, h, w) and fl.shape == (1, 2, h, w)
    assert float(fl.abs().max()) <= 2.0 * 24.0


def test_batch_downsample_frac_mixes_families():
    b = tds.generate_batch(_gen(5), 4, 48, 80, downsample_frac=0.5)
    assert b["img1"].shape == (4, 1, 48, 80)
    g = _gen(5)
    native = tds.generate_pair(g, 2, 48, 80, 4, 24.0, 10.0)
    scaled = tds.generate_pair_scale2(g, 2, 48, 80, 4, 24.0, 10.0)
    assert torch.equal(b["img1"][:2], native[0])
    assert torch.equal(b["img1"][2:], scaled[0])
    assert torch.equal(b["flow"][2:], scaled[2])


def test_local_motion_regime():
    h, w, n = 96, 128, 12
    img1, img2, flow = tds.generate_pair(_gen(0), n, h, w, n_objects=2,
                                         max_shift=24.0, bg_max_shift=10.0,
                                         local_motion_frac=1.0)
    mag = torch.sqrt(torch.sum(flow ** 2, dim=1)).numpy()
    warped = tflow.warp(img2, flow)[:, 0].numpy()
    i1 = img1[:, 0].numpy()
    bg_small = obj_large = 0
    for s in range(n):
        border = np.concatenate([mag[s, :2].ravel(), mag[s, -2:].ravel()])
        bg_small += int(np.median(border) < 1.0)
        obj_large += int(mag[s].max() > 5.0)
        assert mag[s].max() > 0.8, (s, mag[s].max())
        a = np.stack([warped[s].ravel(), np.ones(warped[s].size)], axis=1)
        coef, *_ = np.linalg.lstsq(a, i1[s].ravel(), rcond=None)
        err = np.abs(coef[0] * warped[s] + coef[1] - i1[s])
        assert np.quantile(err, 0.3) < 0.05, (s, np.quantile(err, 0.3))
    assert bg_small >= n * 2 // 3, bg_small
    assert obj_large >= n // 4, obj_large


def test_local_motion_frac_zero_is_identity():
    a = tds.generate_pair(_gen(3), 1, 64, 96, n_objects=3, real_frac=0.0)
    b = tds.generate_pair(_gen(3), 1, 64, 96, n_objects=3, real_frac=0.0,
                          local_motion_frac=0.0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_rgb_generation_same_geometry_as_gray():
    g1, _, gflow = tds.generate_pair(_gen(12), 1, 48, 64,
                                     local_motion_frac=0.5)
    c1, c2, cflow = tds.generate_pair(_gen(12), 1, 48, 64,
                                      local_motion_frac=0.5, channels=3)
    assert g1.shape == (1, 1, 48, 64) and c1.shape == (1, 3, 48, 64)
    assert torch.equal(gflow, cflow)
    for img in (c1, c2):
        assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
        assert float((img[:, 0] - img[:, 2]).abs().max()) > 0.01


def test_rgb_batch_with_downsample_mix():
    data = tds.generate_batch(_gen(3), 4, 32, 64, downsample_frac=0.5,
                              channels=3)
    assert data["img1"].shape == (4, 3, 32, 64)
    assert data["flow"].shape == (4, 2, 32, 64)
    assert bool(torch.isfinite(data["img1"]).all())


def test_real_bank_leaves_out_the_held_out_photographs():
    with np.load(tds.os.path.join(tds.os.path.dirname(__file__),
                                  "fixtures", "real_textures.npz")) as f:
        training = [k for k in f.files if not k.startswith("heldout_")]
        assert len(training) < len(f.files)
    assert tds._real_bank().shape == (len(training), *tds._REAL_BANK_HW)
    assert np.array_equal(tds._real_bank(), np.asarray(jds._real_bank()))

