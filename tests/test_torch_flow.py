"""The PyTorch port's flow layers and PWC-Net against the JAX package's.

The port is NCHW, the JAX package NHWC; inputs come from seeded numpy and
are transposed at the boundary. pwc_v7 weights are carried across by
``params_from_flax``.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu.config import FlowNetConfig as JFlowCfg
from moving_object_detector_tpu.models import pwc_net as jpwc
from moving_object_detector_tpu.ops import flow_ops as jflow
from moving_object_detector_tpu.utils.checkpoint import (
    load_flow_checkpoint as j_load,
)
from moving_object_detector_tpu_torch.config import FlowNetConfig as TFlowCfg
from moving_object_detector_tpu_torch.models import pwc_net as tpwc
from moving_object_detector_tpu_torch.ops import flow_corr_cuda
from moving_object_detector_tpu_torch.ops import flow_ops as tflow
from moving_object_detector_tpu_torch.utils.checkpoint import (
    load_flow_checkpoint as t_load,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V7 = os.path.join(ROOT, "weights", "pwc_v7.fp16.npz")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


@pytest.mark.parametrize("r", [4, 2])
@pytest.mark.parametrize("h,w,c", [(3, 10, 196), (6, 20, 128), (13, 37, 7)])
def test_correlation_matches(h, w, c, r):
    rng = np.random.default_rng(h * w + c)
    f1 = rng.normal(size=(1, h, w, c)).astype(np.float32)
    f2 = rng.normal(size=(1, h, w, c)).astype(np.float32)
    ref = np.asarray(jflow.correlation(jnp.asarray(f1), jnp.asarray(f2), r))
    out = flow_corr_cuda.correlation(_nchw(f1), _nchw(f2), r)
    assert tuple(out.shape) == (1, (2 * r + 1) ** 2, h, w)
    np.testing.assert_allclose(_nhwc(out), ref, rtol=0, atol=1e-5)


def test_warp_matches():
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(2, 12, 20, 5)).astype(np.float32)
    flow = rng.uniform(-6, 6, size=(2, 12, 20, 2)).astype(np.float32)
    ref = np.asarray(jflow.warp(jnp.asarray(feats), jnp.asarray(flow)))
    out = tflow.warp(_nchw(feats), _nchw(flow))
    np.testing.assert_allclose(_nhwc(out), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [(24, 40), (6, 10), (13, 17)])
def test_resize_bilinear_matches(size):
    x = np.random.default_rng(2).normal(size=(1, 12, 20, 3)).astype(
        np.float32)
    ref = np.asarray(jflow.resize_bilinear(jnp.asarray(x), size))
    out = tflow.resize_bilinear(_nchw(x), size)
    np.testing.assert_allclose(_nhwc(out), ref, rtol=0, atol=1e-6)


def test_infer_flow_config_all_checkpoints():
    paths = sorted(glob.glob(os.path.join(ROOT, "weights", "*.npz")))
    assert len(paths) == 8
    for path in paths:
        with np.load(path) as z:
            shapes = {k: z[k].shape for k in z.files}
        ref = jpwc.infer_flow_config(shapes)
        out = tpwc.infer_flow_config(shapes)
        for f in ("pyramid_levels", "feature_channels", "estimator_channels",
                  "context_channels", "use_context_net", "search_range",
                  "in_channels", "occlusion_cue"):
            assert getattr(out, f) == getattr(ref, f), (path, f)


def _crop_pair():
    tex = np.load(os.path.join(ROOT, "tests", "fixtures",
                               "real_textures.npz"))["china"]
    img = tex.astype(np.float32) / 255.0
    a = img[100:164, 200:328]
    b = img[102:166, 197:325]  # content moves by (+3, -2) px
    return a, b


def _flows(dtype):
    a, b = _crop_pair()
    jparams, jc = j_load(V7, JFlowCfg(dtype=dtype, corr_backend="xla"))
    jmodel = jpwc.PWCNet(config=jc)
    ref, _ = jmodel.apply(jparams, jnp.asarray(a)[None, ..., None],
                          jnp.asarray(b)[None, ..., None])
    tmodel, tc = t_load(V7, TFlowCfg(dtype=dtype), device="cpu")
    assert tc.occlusion_cue and tc.use_context_net
    with torch.no_grad():
        out, _ = tmodel(torch.from_numpy(a)[None, None],
                        torch.from_numpy(b)[None, None])
    return _nhwc(out)[0], np.asarray(ref, np.float32)[0]


def test_pwc_v7_float32_matches():
    out, ref = _flows("float32")
    assert np.abs(ref).mean() > 0.5  # a real, non-trivial flow
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


def test_pwc_v7_bfloat16_matches():
    """bf16 rounds at other places in the two frameworks: mean |diff| <=
    0.05 px (measured on this crop: max |diff| 0.033 px, mean 0.0094 px;
    in f32 the max is 2.2e-6 px)."""
    out, ref = _flows("bfloat16")
    assert np.abs(out - ref).mean() <= 0.05


def test_pipeline_corr_backend_reaches_the_net(monkeypatch):
    """The pipeline's ``flownet.corr_backend`` decides which correlation
    the net runs, whatever the net was built with."""
    from moving_object_detector_tpu_torch.pipeline import _flow_forward

    cfg = TFlowCfg(pyramid_levels=4, feature_channels=(8, 16, 32, 32),
                   estimator_channels=(16, 8), use_context_net=False,
                   dtype="float32", corr_backend="pallas")
    torch.manual_seed(0)
    model = tpwc.PWCNet(cfg)
    calls = []
    kernel = flow_corr_cuda.correlation
    monkeypatch.setattr(flow_corr_cuda, "correlation",
                        lambda *a: calls.append(1) or kernel(*a))
    img = torch.from_numpy(np.random.default_rng(4).random(
        (32, 48), np.float32))
    plain = _flow_forward(model, img, img.roll(2, 1), corr_backend="xla")
    assert not calls
    wrapped = _flow_forward(model, img, img.roll(2, 1),
                            corr_backend="pallas")
    assert len(calls) == 2  # levels 3 and 2
    torch.testing.assert_close(wrapped, plain, rtol=0, atol=1e-5)
