"""The port's flow-net training (``train/flow_trainer.py``,
``train/train_flow.py``) against the JAX package's on the CPU.

At ``tests/test_sharding.py``'s SMALL config (3 levels, r = 2, no context
net, f32) on 32 x 64 batches: the loss and ``train_step`` for 3 steps
from the same parameters, the loss within 1e-5 relative and every
parameter after each step within 1e-5 (convolutions and sums in other
orders; measured 3e-7); the schedule, the clip and AdamW against Optax;
``motion_contrast_weights`` at even and odd pixel counts (``jnp.median``
averages the middle pair); ``warp_two_pass`` and the net on it; the
resize at the loss's shrink factors; the checkpoint's way back to the JAX
layout; the CLI; and ``make_sharded_train_step`` on four gloo ranks
(``tests/torch_parallel_worker.py train``) against the single-process
step.
"""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moving_object_detector_tpu.config import FlowNetConfig as JCfg
from moving_object_detector_tpu.models.pwc_net import PWCNet as JNet
from moving_object_detector_tpu.ops import flow_ops as jflow
from moving_object_detector_tpu.train import flow_trainer as jft
from moving_object_detector_tpu.utils import checkpoint as jckpt
from moving_object_detector_tpu_torch.config import FlowNetConfig as TCfg
from moving_object_detector_tpu_torch.models import pwc_net as tpwc
from moving_object_detector_tpu_torch.ops import flow_ops as tflow
from moving_object_detector_tpu_torch.train import flow_trainer as tft
from moving_object_detector_tpu_torch.train import train_flow
from moving_object_detector_tpu_torch.utils import checkpoint as tckpt

import torch_parallel_worker as tw

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
SMALL = dict(feature_channels=(8, 16, 32), search_range=2,
             use_context_net=False, dtype="float32")
TOL_LOSS = 1e-5  # relative
TOL_PARAMS = 1e-5  # absolute, every parameter after each step


def _flat(params) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def small():
    """(JAX net, its train state and tx, the port's net with the same
    parameters)."""
    jm = JNet(config=JCfg(**SMALL))
    jstate, tx = jft.create_train_state(jm, 32, 64)
    tm = tpwc.PWCNet(TCfg(**SMALL))
    tm.load_state_dict(tckpt.params_from_flax(_flat(jstate.params)))
    return jm, jstate, tx, tm


def _batches(k):
    return (jft.synthetic_flow_batch(np.random.default_rng(k), 8, 32, 64),
            tft.synthetic_flow_batch(np.random.default_rng(k), 8, 32, 64))


@pytest.mark.parametrize("h,w", [(32, 48), (31, 47)],
                         ids=["even", "odd"])
def test_motion_contrast_weights_equal_jax(h, w):
    rng = np.random.default_rng(h)
    gt = np.zeros((2, h, w, 2), np.float32)
    gt[0, 8:16, 10:22, 0] = 10.0
    gt[0] += rng.normal(0, 0.3, (h, w, 2)).astype(np.float32)
    gt[1] = rng.normal(2.0, 1.5, (h, w, 2)).astype(np.float32)
    for strength in (4.0, 0.5):
        ref = np.asarray(jft.motion_contrast_weights(jnp.asarray(gt),
                                                     strength))
        out = tft.motion_contrast_weights(torch.from_numpy(_nchw(gt).copy()),
                                          strength).numpy()
        # 1e-5: XLA's f32 mean over the image sums in order, PyTorch's
        # pairwise (measured 2.7e-6 apart at 32 x 48).
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    # The median of an even count is the middle pair's mean.
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    assert float(tft._median(x)) == 2.5 == float(jnp.median(x.numpy()))


@pytest.mark.parametrize("contrast", [0.0, 4.0])
def test_flow_loss_equals_jax(small, contrast):
    jm, jstate, _, tm = small
    jb, tb = _batches(5)
    jl, je = jft.flow_loss(jm, jstate.params, jb["img1"], jb["img2"],
                           jb["flow"], motion_contrast=contrast)
    with torch.no_grad():
        tl, te = tft.flow_loss(tm, tb["img1"], tb["img2"], tb["flow"],
                               motion_contrast=contrast)
    assert abs(float(tl) / float(jl) - 1) <= TOL_LOSS
    assert abs(float(te) / float(je) - 1) <= TOL_LOSS


def test_flow_loss_motion_contrast_zero_is_uniform(small):
    tm = small[3]
    _, tb = _batches(6)
    tb["flow"][0, 0, 8:16, 10:22] = 10.0  # an independent mover
    with torch.no_grad():
        l0, e0 = tft.flow_loss(tm, tb["img1"], tb["img2"], tb["flow"])
        l1, e1 = tft.flow_loss(tm, tb["img1"], tb["img2"], tb["flow"], 0.0)
        l2, e2 = tft.flow_loss(tm, tb["img1"], tb["img2"], tb["flow"], 4.0)
    assert float(l0) == float(l1) and float(e0) == float(e1)
    assert float(e2) == float(e0) and float(l2) != float(l0)


def test_three_train_steps_equal_jax(small):
    jm, jstate, tx, tm0 = small
    tm = tpwc.PWCNet(TCfg(**SMALL))
    tm.load_state_dict(tm0.state_dict())
    tstate, ttx = tft.create_train_state(tm)
    step = jax.jit(lambda st, b: jft.train_step(jm, tx, st, b))
    for k in range(3):
        jb, tb = _batches(k)
        jstate, jmet = step(jstate, jb)
        tstate, tmet = tft.train_step(tm, ttx, tstate, tb)
        assert abs(float(tmet["loss"]) / float(jmet["loss"]) - 1) <= TOL_LOSS
        ref = _flat(jstate.params)
        out = tckpt.params_to_flax(tm.state_dict())
        worst = max(float(np.abs(out[n] - ref[n]).max()) for n in ref)
        assert worst <= TOL_PARAMS, (k, worst)
    assert tstate.step == 3


def test_schedule_equals_optax():
    peak, warmup, total = 1e-4, 5, 40
    sched = optax.warmup_cosine_decay_schedule(
        0.0, peak, min(warmup, total // 10 + 1), total,
        end_value=peak * 0.02)
    state, tx = tft.create_train_state(tpwc.PWCNet(TCfg(**SMALL)), peak,
                                       total_steps=total, warmup_steps=500)
    assert tx.warmup_steps == total // 10 + 1 == 5
    # f32 against f64: the cosine's 1 + cos(pi t / T) cancels near T.
    for count in range(total + 6):
        np.testing.assert_allclose(tx.lr(count), float(sched(count)),
                                   rtol=1e-5, atol=1e-12)
    for count, lr in ((0, 0.0), (1, 2e-5), (5, 1e-4), (39, 2.197e-6),
                      (40, 2e-6)):
        assert abs(tx.lr(count) - lr) <= 1e-3 * peak, (count, tx.lr(count))
    assert state.optimizer.param_groups[0]["lr"] == 0.0
    assert tft.FlowOptimizer(3e-4).lr(7) == 3e-4


@pytest.mark.parametrize("norm", [0.5, 1.0, 3.0])
def test_clip_by_global_norm_equals_optax(norm):
    rng = np.random.default_rng(int(norm * 10))
    grads = [rng.normal(size=s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 3))]
    scale = norm / np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                               for g in grads))
    grads = [(g * scale).astype(np.float32) for g in grads]
    ref, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    out = [torch.from_numpy(g.copy()) for g in grads]
    got = tft.clip_by_global_norm(out, 1.0)
    assert abs(float(got) - norm) <= 1e-6 * norm
    for o, r, g in zip(out, ref, grads):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-9)
        if norm < 1.0:
            assert np.array_equal(o.numpy(), g)  # left as it is


def test_adamw_equals_optax_over_several_steps():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, 1e-2, 2, 8, end_value=2e-4), weight_decay=4e-4)
    jp, opt = jnp.asarray(p0), None
    opt = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    sched = tft.FlowOptimizer(1e-2, 8, 2)
    adam = torch.optim.AdamW([tp], lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=4e-4)
    for k in range(6):
        g = rng.normal(size=p0.shape).astype(np.float32)
        upd, opt = tx.update(jnp.asarray(g), opt, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        adam.param_groups[0]["lr"] = sched.lr(k)
        adam.step()
        # Optax evaluates the schedule in f32 (1e-5 relative near the
        # cosine's end), AdamW here takes it as a Python float: 1e-6 of
        # parameters that move by about 1e-2 a step.
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_warp_two_pass_equals_jax(dtype):
    rng = np.random.default_rng(1)
    b, h, w, c = 2, 13, 21, 3
    feat = rng.normal(size=(b, h, w, c)).astype(np.float32)
    flow = rng.normal(0, 4.0, (b, h, w, 2)).astype(np.float32)
    flow[0, :3] = 40.0  # beyond the window and the image
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == np.float32
                else (jnp.bfloat16, torch.bfloat16))
    ref = np.asarray(jflow.warp_two_pass(
        jnp.asarray(feat).astype(jdt), jnp.asarray(flow).astype(jdt),
        max_dy=8, max_dx=12).astype(jnp.float32))
    out = tflow.warp_two_pass(
        torch.from_numpy(_nchw(feat).copy()).to(tdt),
        torch.from_numpy(_nchw(flow).copy()).to(tdt), max_dy=8,
        max_dx=12).float().numpy()
    tol = 1e-6 if dtype == np.float32 else 1e-2
    np.testing.assert_allclose(out, _nchw(ref), rtol=0, atol=tol)


def test_net_on_the_two_pass_warp_equals_jax():
    """Four levels (SMALL's three estimate at one level and never warp),
    JAX's random init in both nets."""
    from moving_object_detector_tpu.models.pwc_net import init_pwc_params

    four = dict(SMALL, feature_channels=(8, 16, 32, 32))
    jm = JNet(config=JCfg(**four, warp_backend="two_pass"))
    params = init_pwc_params(jm, 32, 64, jax.random.PRNGKey(3))
    tm = tpwc.PWCNet(TCfg(**four, warp_backend="two_pass"))
    tm.load_state_dict(tckpt.params_from_flax(_flat(params)))
    exact = tpwc.PWCNet(TCfg(**four))
    exact.load_state_dict(tm.state_dict())
    jb, tb = _batches(9)
    ref, _ = jm.apply(params, jb["img1"], jb["img2"])
    with torch.no_grad():
        out, _ = tm(tb["img1"], tb["img2"])
        gather, _ = exact(tb["img1"], tb["img2"])
    np.testing.assert_allclose(out.numpy(), _nchw(ref), rtol=0, atol=1e-5)
    assert not torch.equal(out, gather)  # the approximation is in use


@pytest.mark.parametrize("src,dst", [
    ((192, 448), (24, 56)), ((192, 448), (12, 28)), ((192, 448), (6, 14)),
    ((192, 448), (3, 7)), ((37, 53), (5, 7)), ((37, 53), (3, 2)),
    ((37, 53), (1, 1))])
def test_resize_at_the_loss_factors_equals_jax(src, dst):
    """``flow_loss`` shrinks the truth by 8 to 64 (antialiased); the
    serving path only ever shrank by 2."""
    x = np.random.default_rng(2).normal(0, 5, (2, *src, 2)).astype(
        np.float32)
    ref = np.asarray(jflow.resize_bilinear(jnp.asarray(x), dst))
    out = tflow.resize_bilinear(torch.from_numpy(_nchw(x).copy()),
                                dst).numpy()
    np.testing.assert_allclose(out, _nchw(ref), rtol=0, atol=1e-5)


def test_init_draws_flax_lecun_normal():
    """Truncated at 2 standard deviations of a normal whose variance after
    truncation is 1 / fan_in; zero biases; the same statistics as Flax's
    draw of the same kernel."""
    model = tpwc.init_pwc_params(tpwc.PWCNet(TCfg()),
                                 torch.Generator().manual_seed(0))
    w = model.estimators[0].convs[0].weight.detach()
    fan_in = w.shape[1] * 9
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / fan_in ** 0.5
    assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.01
    assert all(float(m.bias.detach().abs().max()) == 0.0
               for m in model.modules()
               if isinstance(m, tpwc.Conv))
    ref = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (3, 3, w.shape[1], w.shape[0])))
    assert abs(float(w.std()) / float(ref.std()) - 1.0) < 0.01
    again = tpwc.init_pwc_params(tpwc.PWCNet(TCfg()),
                                 torch.Generator().manual_seed(0))
    assert torch.equal(again.estimators[0].convs[0].weight, w)


def test_saved_params_serve_the_same_flow_in_jax(small, tmp_path):
    """``save_flow_params`` to .npz is the JAX package's fp16 archive: its
    loader builds the same net, which gives the port's flow (the port's
    net loaded back from the same file). The directory form keeps f32."""
    tm = small[3]
    path = str(tmp_path / "w.npz")
    tckpt.save_flow_params(path, tm)
    params, cfg = jckpt.load_flow_checkpoint(path, JCfg(dtype="float32"))
    back, tcfg = tckpt.load_flow_checkpoint(path, TCfg(dtype="float32"),
                                            device="cpu")
    assert cfg.feature_channels == tcfg.feature_channels == (8, 16, 32)
    _, tb = _batches(4)
    jb = {k: jnp.asarray(v.numpy().transpose(0, 2, 3, 1))
          for k, v in tb.items()}
    ref, _ = JNet(config=cfg).apply(params, jb["img1"], jb["img2"])
    with torch.no_grad():
        out, _ = back(tb["img1"], tb["img2"])
    np.testing.assert_allclose(out.numpy(), _nchw(ref), rtol=0, atol=1e-4)
    folder = str(tmp_path / "ckpt")
    tckpt.save_flow_params(folder, tm)
    assert os.path.exists(os.path.join(folder, "params.npz"))
    f32, _ = tckpt.load_flow_checkpoint(folder, TCfg(dtype="float32"),
                                        device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        f32.state_dict().values(), tm.state_dict().values()))
    assert tckpt.resolve_flow_checkpoint(folder) == folder


def test_params_to_flax_inverts_params_from_flax():
    path = os.path.join(ROOT, "weights", "pwc_v7.fp16.npz")
    with np.load(path) as f:
        flat = {k: f[k].astype(np.float32) for k in f.files}
    back = tckpt.params_to_flax(tckpt.params_from_flax(flat))
    assert set(back) == set(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


def test_train_flow_main_runs_on_the_cpu(tmp_path, monkeypatch):
    out = io.StringIO()
    ckpt = str(tmp_path / "tiny.npz")
    with redirect_stdout(out):
        rc = train_flow.main(["--tiny", "--steps", "4", "--device", "cpu",
                              "--height", "64", "--width", "96",
                              "--batch", "2", "--chunk", "2",
                              "--checkpoint", ckpt])
    assert rc == 0
    lines = out.getvalue().splitlines()
    assert [ln.split()[:2] for ln in lines] == [["step", "2"],
                                                ["step", "4"]]
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)
    params, cfg = jckpt.load_flow_checkpoint(ckpt, JCfg())
    assert cfg.feature_channels == (8, 16, 32) and cfg.search_range == 2
    # Resume from it on the host-made roll pairs, into a directory.
    out = io.StringIO()
    with redirect_stdout(out):
        assert train_flow.main(["--tiny", "--steps", "2", "--device", "cpu",
                                "--height", "32", "--width", "64",
                                "--batch", "2", "--roll-data", "--resume",
                                ckpt, "--checkpoint",
                                str(tmp_path / "dir")]) == 0
    assert len(out.getvalue().splitlines()) == 2
    assert os.path.exists(tmp_path / "dir" / "params.npz")
    # An NHWC .npz dataset, read as the JAX CLI reads it.
    roll = jft.synthetic_flow_batch(np.random.default_rng(1), 3, 32, 64)
    np.savez(tmp_path / "data.npz", **{k: np.asarray(v)
                                       for k, v in roll.items()})
    out = io.StringIO()
    with redirect_stdout(out):
        assert train_flow.main(["--tiny", "--steps", "2", "--device", "cpu",
                                "--batch", "2", "--dataset",
                                str(tmp_path / "data.npz")]) == 0
    assert len(out.getvalue().splitlines()) == 2
    flags = lambda p: {a.option_strings[0] for a in p._actions}
    from moving_object_detector_tpu.train.train_flow import build_parser

    assert flags(train_flow.build_parser()) == flags(build_parser()) | {
        "--device"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_flow.main(["--tiny", "--steps", "1"])


def test_chunked_step_pool_repeats_one_batch_and_is_reproducible():
    def run():
        torch.manual_seed(0)
        model = tpwc.PWCNet(TCfg(**SMALL))
        state, tx = tft.create_train_state(model)
        fn, state = tft.make_chunked_train_step(model, tx, state, 32, 64, 2,
                                                2, pool=1)
        seen = []
        real = tft.train_step

        def spy(m, t, st, batch, mc=0.0):
            seen.append(batch["img1"].clone())
            return real(m, t, st, batch, mc)

        tft.train_step = spy
        try:
            state, metrics = fn(state)
        finally:
            tft.train_step = real
        return seen, metrics, model

    seen, m1, model1 = run()
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
    _, m2, model2 = run()
    assert float(m1["loss"]) == float(m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(model1.parameters(),
                                                 model2.parameters()))


def test_sharded_step_on_four_ranks_equals_the_single_process_step(
        small, tmp_path):
    """Four gloo ranks as (data 2, model 2): the batch split over "data",
    the parameters and their AdamW state sharded over "model" by
    ``flow_param_sharding``. Each step's loss and parameters equal the
    port's single-process ``train_step`` (the JAX sharding test's
    tolerances: loss 1e-3 relative, parameters 2e-4; measured: the losses
    equal, parameters within 1.0e-4, one AdamW step of lr 1e-4 where a
    near-zero gradient's sign differs between the two orders of summing),
    every rank holds the same full parameters, and a chunk of the chunked
    trainer over the mesh has the single-process chunk's loss."""
    jstate, tm0 = small[1], small[3]
    np.savez(tmp_path / "flow_params.npz", **_flat(jstate.params))
    init = "file://" + str(tmp_path / "train.store")
    env = dict(os.environ, PYTHONPATH=ROOT, MODT_TESTS_REEXECED="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "train", str(r), "4", init, str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    tm = tpwc.PWCNet(TCfg(**SMALL))
    tm.load_state_dict(tm0.state_dict())
    state, tx = tft.create_train_state(tm)
    ref = []
    for k in range(tw.TRAIN_STEPS):
        state, metrics = tft.train_step(tm, tx, state,
                                        tw.train_batch(k, tft))
        ref.append((float(metrics["loss"]),
                    {n: p.detach().clone() for n, p in tm.named_parameters()}))
    chunk_model = tpwc.PWCNet(TCfg(**SMALL))
    chunk_model.load_state_dict(tm0.state_dict())
    chunk_state, chunk_tx = tft.create_train_state(chunk_model)
    chunk_fn, chunk_state = tft.make_chunked_train_step(
        chunk_model, chunk_tx, chunk_state, *tw.TRAIN_CHUNK_ARGS)
    chunk_loss = float(chunk_fn(chunk_state)[1]["loss"])
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    total = sum(p.numel() for p in tm.parameters())
    for r in ranks:
        assert int(r["step"]) == tw.TRAIN_STEPS
        # The chunked trainer over the mesh: the same global batches.
        assert abs(float(r["chunk_loss"]) / chunk_loss - 1) <= 1e-3
        assert len(r["sharded"]) > len(list(tm.parameters())) // 2
        assert int(r["local_numel"]) < total
        for k, (loss, params) in enumerate(ref):
            assert abs(float(r[f"loss{k}"]) / loss - 1) <= 1e-3
            for name, p in params.items():
                got = r[f"step{k}/{name}"]
                np.testing.assert_array_equal(got, ranks[0][f"step{k}/{name}"])
                np.testing.assert_allclose(got, p.numpy(), rtol=0, atol=2e-4)
