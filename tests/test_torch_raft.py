"""The port's RAFT (``models/raft.py``) against the benchmark's plain
reference (``portbench/reference/raft.py``, the published forward written
from the paper and the published code) on seeded weights, on the CPU.

The widths are the published ones; the images are small (128 x 128, a
16 x 16 grid, whose pyramid's coarsest level is 2 x 2: the published
sampler divides by a level's side less one) and the iterations few. In
f32 the port and the reference differ only in the lookup's arithmetic
(the port's plain version of the kernel against ``grid_sample``), so the
flows agree within 1e-4 px; one iteration fewer moves them by far more.
Then the lookup's plain version against ``grid_sample`` at the maps'
borders and outside them, the published state dict's names, and
``detect_step`` with RAFT against the reference's ``run_frame``. The port
and the reference alone: no JAX.
"""

import dataclasses

import pytest
import torch

from moving_object_detector_tpu_torch import StereoModel
from moving_object_detector_tpu_torch import config as tcfg
from moving_object_detector_tpu_torch import pipeline
from moving_object_detector_tpu_torch.models.raft import RAFT
from moving_object_detector_tpu_torch.ops import raft_lookup_cuda
from moving_object_detector_tpu_torch.utils.checkpoint import (
    build_raft,
    load_raft_state_dict,
)
from portbench.reference import raft as ref

torch.set_num_threads(2)

H = W = 128
ITERS = 4
TOL_PX = 1e-4
CFG = tcfg.RAFTConfig(dtype="float32", iters=ITERS)


def _nets(iters=ITERS):
    net = build_raft(CFG, 20032039, "cpu")
    rnet = ref.raft_from_state(net.state_dict(), ref.RAFTConfig(
        dtype="float32", iters=iters), "cpu")
    return net, rnet


def _images(seed=3):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(1, 3, H, W, generator=g)
    return a, torch.roll(a, (2, 3), (-2, -1))


@pytest.fixture(autouse=True)
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_raft_matches_the_reference(backend):
    """Through the kernel's wrapper (its plain version on CPU tensors) and
    through the plain lookup: both flows within 1e-4 px of the
    reference's, a lookup and an iteration counted an update."""
    from moving_object_detector_tpu_torch.utils import profiling

    net, rnet = _nets()
    a, b = _images()
    with torch.no_grad(), profiling.recording() as rec:
        profiling.set_unit(0)
        up, low = net(a, b, corr_backend=backend)
        rup, rlow = rnet(a, b)
    assert up.shape == (1, 2, H, W) and low.shape == (1, 2, H // 8, W // 8)
    assert float((up - rup).abs().max()) <= TOL_PX
    assert float((low - rlow).abs().max()) <= TOL_PX
    assert float(low.abs().max()) > 0.05  # the updates moved the flow
    assert rec.counters[("raft_lookups", 0)] == ITERS
    assert rec.counters[("raft_iterations", 0)] == ITERS
    assert {"raft_encode", "raft_update"} <= {s.name for s in rec.spans()}


def test_one_iteration_short_differs_beyond_the_tolerance():
    net, _ = _nets()
    _, short = _nets(ITERS - 1)
    a, b = _images()
    with torch.no_grad():
        up, _ = net(a, b, corr_backend="xla")
        sup, _ = short(a, b)
    assert float((up - sup).abs().max()) > 100 * TOL_PX


@pytest.mark.parametrize("case", ["inside", "borders", "outside", "batch"])
def test_plain_lookup_equals_grid_sample(case):
    """The plain lookup (the kernel's arithmetic) against the published
    ``grid_sample`` lookup: matches inside the maps, on their borders
    (taps off the edge add nothing), far outside (zeros) and in a batch
    of two, at radii 4 and 2."""
    g = torch.Generator().manual_seed(len(case))
    b = 2 if case == "batch" else 1
    h, w = 6, 9
    pyr = [torch.randn(b * h * w, h, w, generator=g),
           torch.randn(b * h * w, h // 2, w // 2, generator=g),
           torch.randn(b * h * w, 2, 2, generator=g)]
    coords = ref.coords_grid(b, h, w, "cpu")
    if case == "borders":
        coords = torch.stack([torch.full((b, h, w), float(w - 1)),
                              torch.full((b, h, w), -0.5)], dim=1)
        coords[..., 0] = 0.25
    elif case == "outside":
        coords = coords + torch.tensor([60.0, -45.0]).view(1, 2, 1, 1)
    else:
        coords = coords + 3 * (2 * torch.rand(b, 2, h, w, generator=g) - 1)
    for r in (4, 2):
        mine = raft_lookup_cuda.raft_lookup_plain(pyr, coords, r)
        theirs = ref.lookup([p[:, None] for p in pyr], coords, r)
        assert mine.shape == (b, 3 * (2 * r + 1) ** 2, h, w)
        assert float((mine - theirs).abs().max()) <= 1e-5
        assert torch.equal(raft_lookup_cuda.raft_lookup(pyr, coords, r),
                           mine)
    if case == "outside":
        assert not mine[:, :81].any()


def test_a_published_state_dict_loads_strictly():
    """The published names (a ``module.`` prefix, as ``DataParallel``
    saved them, stripped): the port's net and the reference's hold the
    same keys, every one that the published modules name; a missing key
    is refused."""
    net = build_raft(tcfg.RAFTConfig(), 1, "cpu")
    state = {"module." + k: v for k, v in net.state_dict().items()}
    for name in ("fnet.conv1.weight", "cnet.norm1.running_mean",
                 "cnet.layer2.0.norm3.weight",
                 "cnet.layer2.0.downsample.1.running_var",
                 "update_block.encoder.convc1.weight",
                 "update_block.gru.convz1.weight",
                 "update_block.flow_head.conv2.bias",
                 "update_block.mask.2.weight"):
        assert "module." + name in state
    loaded = load_raft_state_dict(state, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        loaded.state_dict().values(), net.state_dict().values()))
    assert set(ref.RAFT().state_dict()) == set(net.state_dict())
    assert sum(p.numel() for p in net.parameters()) == 5_257_536
    state.pop("module.update_block.mask.2.bias")
    with pytest.raises(RuntimeError):
        load_raft_state_dict(state, device="cpu")


def test_detect_step_with_raft_matches_the_reference_run_frame():
    """Three pairs through ``detect_step`` with RAFT on the CPU, each
    pair's flow within 1e-4 px of the reference's ``run_frame`` from the
    same state, and its disparity equal."""
    from portbench.core import judge_serve
    from portbench.reference import config as rconfig, step, types

    h, w, fx = 128, 160, 90.0
    cfg = dataclasses.replace(CFG, iters=3)
    net = build_raft(cfg, 7, "cpu")
    rnet = ref.raft_from_state(net.state_dict(), ref.RAFTConfig(
        dtype="float32", iters=3), "cpu")
    config = tcfg.PipelineConfig(height=h, width=w, flownet=cfg,
                                 sgm=tcfg.SGMConfig(max_disparity=16))
    rcfg = rconfig.PipelineConfig(height=h, width=w,
                                  sgm=rconfig.SGMConfig(max_disparity=16))
    stereo = StereoModel.create(fx, fx, w / 2, h / 2, 0.5, device="cpu")
    rstereo = types.StereoModel.create(fx, fx, w / 2, h / 2, 0.5,
                                       device="cpu")
    g = torch.Generator().manual_seed(11)
    base = torch.rand(h, w + 8, generator=g)
    state = pipeline.PipelineState.create(config, device="cpu")
    for k in range(3):
        left = base[:, 2 * k:2 * k + w].contiguous()
        right = base[:, 2 * k + 4:2 * k + 4 + w].contiguous()
        prev = judge_serve.state_dict_of(state)
        state, out = pipeline.detect_step(net, state, left, right, 0.1 * k,
                                          stereo, config)
        with torch.no_grad():
            want, _ = step.run_frame(rnet, prev, left, right, 0.1 * k,
                                     rstereo, rcfg)
        assert out.flow.shape == (h, w, 2)
        assert float((out.flow - want["flow"]).abs().max()) <= TOL_PX
        assert torch.equal(out.disparity.disparity,
                           want["disparity"].disparity)


def test_raft_configuration_refuses_what_the_net_cannot_take():
    with pytest.raises(ValueError):
        tcfg.RAFTConfig(corr_backend="cuda")
    with pytest.raises(ValueError):
        tcfg.RAFTConfig(feature_channels=(64, 96))
    assert isinstance(RAFT(tcfg.RAFTConfig(iters=1)), torch.nn.Module)
    assert hash(tcfg.PipelineConfig(flownet=tcfg.RAFTConfig()))
