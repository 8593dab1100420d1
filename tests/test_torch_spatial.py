"""The port's row-striped perception and multi-process plumbing
(``parallel/{mesh,spatial,multihost}.py`` over ``torch.distributed``)
against the JAX package's (``shard_map`` on the virtual 8-device CPU
mesh of ``tests/conftest.py``).

The port runs as separate processes: four gloo ranks
(``tests/torch_parallel_worker.py spatial``) form a (1, 4) and a (2, 2)
mesh and run ``tests/test_spatial.py``'s cases, started once for the
file; two more (``... multihost``) run ``tests/test_multihost.py``'s
smoke. The JAX side runs here on the same numpy inputs, on meshes of the
same shapes. The SGM stripes must equal the JAX package's bit for bit
(both run the plain SGM on the same halo-extended stripes), the flow
within 1e-3 (f32 convolutions summed in other orders). These are CPU
processes: they check the exchange, the gathers and the seams, not the
speed of several cards, which a one-card machine cannot measure.
"""

import os
import socket
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import config as jcfg
from moving_object_detector_tpu.models.pwc_net import (
    PWCNet as JPWCNet,
    init_pwc_params,
)
from moving_object_detector_tpu.parallel.mesh import (
    _conv_kernel_spec,
    create_mesh,
)
from moving_object_detector_tpu.parallel.spatial import (
    compute_disparity_spatial,
    detect_step_streams_spatial,
    flow_forward_spatial,
)
from moving_object_detector_tpu.parallel.streams import create_stream_states
from moving_object_detector_tpu.ops.sgm import disparity_with_metadata
from moving_object_detector_tpu.types import StereoModel as JStereo
from moving_object_detector_tpu_torch import config as tcfg
from moving_object_detector_tpu_torch.models.pwc_net import PWCNet
from moving_object_detector_tpu_torch.ops.sgm import sgm_disparity_raw
from moving_object_detector_tpu_torch.parallel.mesh import (
    _conv_kernel_spec as port_spec,
)
from moving_object_detector_tpu_torch.pipeline import _flow_forward
from moving_object_detector_tpu_torch.utils.checkpoint import params_from_flax
from torch.distributed.tensor import Shard

import torch_parallel_worker as tw
from test_torch_pipeline import _flat

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
SGM_CFG = dict(max_disparity=32, backend="xla")


def _spawn(task, world, outdir):
    init = "file://" + os.path.join(outdir, f"{task}.store")
    env = dict(os.environ, PYTHONPATH=ROOT, MODT_TESTS_REEXECED="1")
    return [subprocess.Popen(
        [sys.executable, WORKER, task, str(r), str(world), init, outdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def _wait(procs):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
    return outs


def _jstereo(h, w, baseline=0.5):
    return JStereo.create(fx=100.0, fy=100.0, cx=w / 2, cy=h / 2,
                          baseline=baseline)


def _jax_sgm(name):
    h, w, d_true, seed, mp, halo = tw.SGM_CASES[name]
    left, right = map(jnp.asarray, tw.stereo_pair(h, w, d_true, seed))
    return np.asarray(compute_disparity_spatial(
        left, right, _jstereo(h, w), jcfg.SGMConfig(**SGM_CFG),
        create_mesh(4, model_parallel=mp), halo=halo).disparity)


def _jax_flow(jmodel, params):
    img1, img2 = map(jnp.asarray, tw.flow_pair())
    return np.asarray(flow_forward_spatial(
        params, jmodel, img1, img2, create_mesh(4, model_parallel=4),
        halo=tw.FLOW_HALO))


def _jax_pwc():
    """pwc_v7 at scale 2 in the JAX package: (striped, unsharded). The
    stripes are the rows its ``flow_forward_spatial`` gives each of two
    devices with bench.py's halo (the neighbour's rows, edge replication
    at the border), each through one compiled ``_flow_forward``: the
    sharded program itself takes minutes to compile on the CPU."""
    from moving_object_detector_tpu.pipeline import _flow_forward as jflow
    from moving_object_detector_tpu.utils.checkpoint import (
        load_flow_checkpoint,
    )

    params, cfg = load_flow_checkpoint(
        os.path.join(ROOT, "weights", "pwc_v7.fp16.npz"))
    model = JPWCNet(config=cfg)
    flow = jax.jit(lambda p, q: jflow(params, model, p, q, input_scale=2))
    halo, s = tw.PWC_HALO, tw.PWC_HW[0] // 2

    def stripes(x):
        xp = np.concatenate([np.repeat(x[:1], halo, 0), x,
                             np.repeat(x[-1:], halo, 0)])
        return [xp[r * s:(r + 1) * s + 2 * halo] for r in range(2)]

    a, b = tw.pwc_pair()
    striped = np.concatenate([np.asarray(flow(p, q))[halo:halo + s]
                              for p, q in zip(stripes(a), stripes(b))])
    return striped, np.asarray(flow(a, b))


def _jax_composition(jmodel, params, ranks):
    """Frame 1 of the composed step in the JAX package. Its state after
    frame 0 is built from the port's frame-0 disparity (frame 0 has no
    previous frame: the tracker and pose stay as created, only the
    previous frame's fields change), which saves a second compilation of
    the composed step; frame 1's disparity is compared bit for bit."""
    h, w = tw.COMP_HW
    config = tw.composition_config(jcfg)
    lefts, rights = map(jnp.asarray, tw.composition_scenes())
    mesh = create_mesh(4, model_parallel=2)
    stereo = _jstereo(h, w, 0.48)
    disp0 = {int(r["data_index"]): r["sp0_disparity"][0] for r in ranks}
    prev = jax.vmap(lambda d: disparity_with_metadata(d, stereo,
                                                      config.sgm))(
        jnp.asarray(np.stack([disp0[d] for d in range(tw.COMP_N)])))
    n = tw.COMP_N
    states = create_stream_states(config, n).replace(
        prev_left=lefts, prev_disparity=prev,
        prev_time=jnp.full((n,), 0.1, jnp.float32),
        has_prev=jnp.ones((n,), bool), frame_index=jnp.ones((n,), jnp.int32))
    with mesh:
        _, out = detect_step_streams_spatial(
            params, states, lefts, rights, jnp.full((n,), 0.2, jnp.float32),
            stereo, config, jmodel, mesh, **tw.COMP_HALOS)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The workers, started once for the file, and the JAX side, computed
    in threads while they run (the compilations overlap)."""
    outdir = str(tmp_path_factory.mktemp("torch_parallel"))
    jmodel = JPWCNet(config=tw.flow_config(jcfg))
    params = init_pwc_params(jmodel, *tw.FLOW_HW, jax.random.PRNGKey(0))
    np.savez(os.path.join(outdir, "flow_params.npz"), **_flat(params))
    spatial = _spawn("spatial", 4, outdir)
    smoke = _spawn("multihost", 2, outdir)
    with ThreadPoolExecutor(4) as pool:
        jax_runs = {name: pool.submit(_jax_sgm, name)
                    for name in tw.SGM_CASES}
        jax_runs["flow_m4"] = pool.submit(_jax_flow, jmodel, params)
        jax_runs["pwc"] = pool.submit(_jax_pwc)
        try:
            _wait(spatial)
            ranks = [dict(np.load(os.path.join(outdir, f"rank{r}.npz")))
                     for r in range(4)]
            jax_runs["composition"] = pool.submit(_jax_composition, jmodel,
                                                  params, ranks)
            yield types.SimpleNamespace(
                params=params, ranks=ranks,
                jax=lambda name: jax_runs[name].result(),
                multihost=lambda: _wait(smoke))
        finally:
            for p in spatial + smoke:
                if p.poll() is None:
                    p.kill()


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


def test_sgm_spatial_matches_single_device(run):
    h, w, d_true, seed, _, _ = tw.SGM_CASES["sgm_m4"]
    out = _same_on_every_rank(run.ranks, "sgm_m4")
    np.testing.assert_array_equal(out, run.jax("sgm_m4"))
    ref = sgm_disparity_raw(
        *map(torch.from_numpy, tw.stereo_pair(h, w, d_true, seed)),
        tcfg.SGMConfig(**SGM_CFG)).numpy()
    both_valid = (ref >= 0) & (out >= 0)
    assert (ref >= 0).mean() > 0.5
    assert ((ref >= 0) == (out >= 0)).mean() > 0.97
    diff = np.abs(ref - out)[both_valid]
    assert (diff <= 1.0).mean() > 0.98
    assert (diff == 0.0).mean() > 0.90


def test_sgm_spatial_recovers_true_disparity(run):
    h, w, d_true, _, _, _ = tw.SGM_CASES["sgm_m2"]
    out = _same_on_every_rank(run.ranks, "sgm_m2")
    np.testing.assert_array_equal(out, run.jax("sgm_m2"))
    valid = out[:, d_true + 2:][out[:, d_true + 2:] >= 0]
    assert valid.size > 0.5 * h * w
    assert np.median(np.abs(valid - d_true)) < 0.51


def test_flow_spatial_matches_single_device(run):
    img1, img2 = tw.flow_pair()
    out = _same_on_every_rank(run.ranks, "flow_m4")
    np.testing.assert_allclose(out, run.jax("flow_m4"), rtol=0, atol=1e-3)
    model = PWCNet(tw.flow_config(tcfg))
    model.load_state_dict(params_from_flax(_flat(run.params)))
    ref = _flow_forward(model, torch.from_numpy(img1),
                        torch.from_numpy(img2)).numpy()
    assert out.shape == ref.shape
    err = np.abs(out - ref)
    assert np.median(err) < 0.05, np.median(err)
    assert np.mean(err < 0.25) > 0.9, np.mean(err < 0.25)


def test_striped_pwc_v7_flow_matches_the_reference_striping(run):
    """The serving weights (pwc_v7, 6 levels, bf16) at scale 2, striped
    in two with bench.py's flow halo: the port's striped flow within bf16
    noise of the JAX package's (median 0.05 px), and its error against its
    own unsharded flow that of the reference within 0.05 px. At pwc_v7
    the striping error is the reference's own and far above the 0.1 px
    of ``tests/test_spatial.py``'s three-level net: the coarsest level
    sees 64 net pixels, the halo 32, and the stripe's padding to the
    pyramid stride differs from the image's."""
    from moving_object_detector_tpu_torch.utils.checkpoint import (
        load_flow_checkpoint,
    )

    striped = _same_on_every_rank(run.ranks, "pwc_striped")
    jstriped, junsharded = run.jax("pwc")
    model, _ = load_flow_checkpoint(
        os.path.join(ROOT, "weights", "pwc_v7.fp16.npz"), device="cpu")
    unsharded = _flow_forward(model, *map(torch.from_numpy, tw.pwc_pair()),
                              input_scale=2).numpy()
    err = float(np.median(np.abs(striped - unsharded)))
    jerr = float(np.median(np.abs(jstriped - junsharded)))
    assert np.median(np.abs(striped - jstriped)) < 0.05
    assert abs(err - jerr) < 0.05, (err, jerr)


def test_sgm_spatial_halo_bounds_checked(run):
    """A halo past the stripe and a height the axis does not divide raise
    AssertionError in both packages."""
    for r in run.ranks:
        assert r["asserts_raised"].tolist() == [True, True]
    left = jnp.zeros((64, 160), jnp.float32)
    with pytest.raises(AssertionError):
        compute_disparity_spatial(left, left, _jstereo(64, 160),
                                  jcfg.SGMConfig(**SGM_CFG),
                                  create_mesh(4, model_parallel=4), halo=17)


def test_flow_param_sharding_follows_the_jax_rule(run):
    """Leaf by leaf: the port shards a parameter's output channel over
    "model" exactly where the JAX rule shards its kernel's last axis (the
    weights carried across by ``params_from_flax``, which renames each
    Flax leaf)."""
    flat = _flat(run.params)
    keys = sorted(flat)
    # Each leaf's value becomes its index, so the renamed state dict says
    # which Flax leaf each port parameter came from.
    tagged = params_from_flax({k: np.full_like(flat[k], i)
                               for i, k in enumerate(keys)})
    leaves = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  run.params)[0]}
    paths = {"/".join(str(getattr(k, "key", k)) for k in path): path
             for path, _ in jax.tree_util.tree_flatten_with_path(
                 run.params)[0]}
    sharded = set()
    for name, value in tagged.items():
        key = keys[int(value.flatten()[0])]
        jspec = _conv_kernel_spec(paths[key], leaves[key])
        jax_shards = len(jspec) > 0 and jspec[-1] == "model"
        assert (port_spec(name, value) == Shard(0)) == jax_shards, name
        if jax_shards:
            sharded.add(name)
    assert sharded, "no parameter shards"
    for r in run.ranks:  # flow_param_sharding on the (2, 2) mesh
        assert set(r["sharded_params"].tolist()) == sharded
        assert bool(r["replicated_over_data"])


def test_detect_step_streams_spatial_composition(run):
    """Streams x spatial: 2 streams over "data" x 2-way row stripes over
    "model". Every rank of a stream group returns the same step; (a) the
    batched step fed the composed step's heavy outputs reproduces it bit
    for bit; (b) it agrees with the JAX package's composed step (SGM
    bitwise, flow 1e-3, motion 1e-4, label images equal) and, away from
    the seams, with the unsharded batched step."""
    ranks = run.ranks
    by_group = {}
    for r in ranks:
        by_group.setdefault(int(r["data_index"]), []).append(r)
    assert sorted(by_group) == [0, 1]
    for group in by_group.values():
        for key in group[0]:
            np.testing.assert_array_equal(group[1][key], group[0][key],
                                          err_msg=key)

    h, w = tw.COMP_HW
    jout = run.jax("composition")
    for d, (r, _) in sorted(by_group.items()):
        # (a) plumbing exactness.
        np.testing.assert_array_equal(r["ref_velocity"], r["sp_velocity"])
        np.testing.assert_array_equal(r["ref_label"], r["sp_label"])
        # (b) the JAX package's composed step on the same inputs.
        np.testing.assert_array_equal(
            r["sp_disparity"][0], np.asarray(jout.disparity.disparity[d]))
        np.testing.assert_allclose(r["sp_flow"][0], np.asarray(jout.flow[d]),
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(r["sp_motion"][0],
                                   np.asarray(jout.motion[d]), rtol=0,
                                   atol=1e-4)
        np.testing.assert_array_equal(r["sp_label"][0],
                                      np.asarray(jout.label_image[d]))
        assert bool(r["sp_frame_valid"][0]) == bool(jout.frame_valid[d])
        # Seam-tolerant agreement with the unsharded batched step.
        d_sp, d_pl = r["sp_disparity"], r["pl_disparity"]
        assert d_sp.shape == (1, h, w)
        assert ((d_sp >= 0) == (d_pl >= 0)).mean() > 0.95
        both = (d_sp >= 0) & (d_pl >= 0)
        assert both.mean() > 0.5
        assert (np.abs(d_sp - d_pl)[both] <= 1.0).mean() > 0.97
        assert np.median(np.abs(r["sp_flow"] - r["pl_flow"])) < 0.1
        # Static scene: neither path may detect motion.
        assert not r["sp_valid"].any() and not r["pl_valid"].any()
        assert r["sp_frame_valid"].all()


def test_two_process_multihost_smoke(run):
    """``tests/test_multihost.py`` on the port: two gloo processes, one
    camera stream each, a global batch whose sum crosses the process
    boundary, host-local results, the detection step on each rank."""
    outs = run.multihost()
    for i, out in enumerate(outs):
        assert f"worker {i} ok 72.0" in out, out


def test_free_port_rendezvous_is_accepted():
    """``initialize`` takes a "host:port" coordinator, as the JAX module
    does; the workers above use a file:// URL."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = (
        "import torch.distributed as dist\n"
        "from moving_object_detector_tpu_torch.parallel import multihost\n"
        f"multihost.initialize('127.0.0.1:{port}', 1, 0, device='cpu')\n"
        f"multihost.initialize('127.0.0.1:{port}', 1, 0, device='cpu')\n"
        "assert dist.get_world_size() == 1 and dist.get_backend() == 'gloo'\n"
        "mesh = multihost.global_stream_mesh()\n"
        "assert mesh.shape == (1, 1)\n"
        "dist.destroy_process_group()\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr
