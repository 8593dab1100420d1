"""The port's ``alg`` toolkit against the JAX package's: each case of
``tests/test_alg.py`` on both packages with the same seeded numpy inputs,
the reference test's own assertions on the port's results, and the two
packages' results compared. Both compute in f32; where they run the same
operations in the same order the results are equal, elsewhere (solves,
determinants, transcendental functions, prefix sums, an estimator
recursion) within the stated tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from moving_object_detector_tpu.alg import boosting as jb
from moving_object_detector_tpu.alg import classifiers as jc
from moving_object_detector_tpu.alg import gaussian as jg
from moving_object_detector_tpu.alg import icf as ji
from moving_object_detector_tpu_torch.alg import boosting as tb
from moving_object_detector_tpu_torch.alg import classifiers as tc
from moving_object_detector_tpu_torch.alg import gaussian as tg
from moving_object_detector_tpu_torch.alg import icf as ti

torch.set_num_threads(2)
CPU = "cpu"
RTOL = 1e-5  # f32 results of different operation orders


def t(*xs):
    """numpy / Python values as f32 CPU tensors."""
    out = tuple(torch.tensor(np.asarray(x, np.float32)) for x in xs)
    return out if len(out) > 1 else out[0]


def _leaves(state):
    """The tensors of a (nested) NamedTuple state, in field order."""
    return [x for f in state
            for x in (_leaves(f) if isinstance(f, tuple) else (f,))]


def close(port, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# gaussian
# ---------------------------------------------------------------------------


def test_gaussian_prob_uni_matches_closed_form():
    mean, var, x = 1.5, 0.7, 2.3
    expected = (1.0 / np.sqrt(2 * np.pi * var)
                * np.exp(-((x - mean) ** 2) / (2 * var)))
    p = tg.gaussian_prob_uni(*t(mean, var, x))
    assert np.isclose(float(p), expected)
    assert float(p) == float(jg.gaussian_prob_uni(mean, var, x))


def test_gaussian_prob_diag_cov_is_product_of_uni():
    mean, var, x = (np.array(v, np.float32) for v in (
        [0.5, -1.0, 2.0], [0.4, 1.2, 0.9], [0.1, 0.0, 2.5]))
    mul = tg.gaussian_prob(*t(mean, np.diag(var), x))
    uni = torch.prod(tg.gaussian_prob_uni(*t(mean, var, x)))
    assert np.isclose(float(mul), float(uni), rtol=1e-5)
    close(mul, jg.gaussian_prob(mean, np.diag(var), x))


def test_gaussian_prob_batched():
    mean = np.zeros((4, 2), np.float32)
    cov = np.broadcast_to(np.eye(2, dtype=np.float32), (4, 2, 2))
    p = tg.gaussian_prob(*t(mean, cov, mean))
    assert tuple(p.shape) == (4,)
    assert np.allclose(p.numpy(), 1.0 / (2 * np.pi), rtol=1e-5)
    close(p, jg.gaussian_prob(mean, cov, mean))


def test_mahalanobis_identity_cov_is_sq_distance():
    mean, x = np.array([1.0, 2.0]), np.array([4.0, 6.0])
    d2 = tg.squared_mahalanobis(*t(mean, np.eye(2), x))
    assert np.isclose(float(d2), 25.0)
    close(d2, jg.squared_mahalanobis(mean, jnp.eye(2), x))
    uni = tg.squared_mahalanobis_uni(*t(1.0, 4.0, 5.0))
    assert float(uni) == float(jg.squared_mahalanobis_uni(1.0, 4.0, 5.0))
    assert np.isclose(float(uni), 4.0)


def test_fit_gaussian_matches_numpy():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(200, 3)).astype(np.float32) @ np.diag(
        [1.0, 2.0, 0.5]).astype(np.float32) + np.asarray([1.0, -2.0, 0.0],
                                                          np.float32)
    mean, cov = tg.fit_gaussian(t(data))
    assert np.allclose(mean.numpy(), data.mean(0), atol=1e-4)
    d = data - data.mean(0)
    assert np.allclose(cov.numpy(), d.T @ d / len(data), atol=1e-3)
    jm, jcov = jg.fit_gaussian(jnp.asarray(data))
    # 200-term f32 sums in another order: within 1e-6 absolute.
    close(mean, jm, rtol=0, atol=1e-6)
    close(cov, jcov, rtol=0, atol=1e-6)


def test_fit_gaussian_weighted_mask_equals_subset():
    rng = np.random.default_rng(1)
    data = rng.normal(size=(50, 2)).astype(np.float32)
    w = (np.arange(50) < 30).astype(np.float32)
    m1, c1 = tg.fit_gaussian(*t(data, w))
    m2, c2 = tg.fit_gaussian(t(data[:30]))
    assert np.allclose(m1.numpy(), m2.numpy(), atol=1e-5)
    assert np.allclose(c1.numpy(), c2.numpy(), atol=1e-5)
    jm, jcov = jg.fit_gaussian(jnp.asarray(data), jnp.asarray(w))
    close(m1, jm, rtol=0, atol=1e-6)
    close(c1, jcov, rtol=0, atol=1e-6)


def test_kl_divergence_zero_for_identical_and_uni_consistency():
    mean = np.array([1.0, 2.0])
    cov = np.array([[2.0, 0.3], [0.3, 1.0]])
    kl0 = tg.kl_divergence(*t(mean, cov, mean, cov))
    assert np.isclose(float(kl0), 0.0, atol=1e-5)
    close(kl0, jg.kl_divergence(mean, cov, mean, cov), rtol=0, atol=1e-6)
    args = ([1.0], [[0.5]], [2.0], [[1.5]])
    kl_m = tg.kl_divergence(*t(*args))
    kl_u = tg.kl_divergence_uni(*t(1.0, 0.5, 2.0, 1.5))
    assert np.isclose(float(kl_m), float(kl_u), rtol=1e-5)
    close(kl_m, jg.kl_divergence(*map(jnp.asarray, args)))
    close(kl_u, jg.kl_divergence_uni(1.0, 0.5, 2.0, 1.5))


def test_l2_distance_uni_zero_means_close():
    d = tg.l2_distance_uni(*t(0.3, 1.1, 0.3, 1.1))
    assert np.isclose(float(d), 0.0, atol=1e-6)
    close(d, jg.l2_distance_uni(0.3, 1.1, 0.3, 1.1), rtol=0, atol=1e-7)
    far = tg.l2_distance_uni(*t(0.3, 1.1, 2.0, 0.4))
    close(far, jg.l2_distance_uni(0.3, 1.1, 2.0, 0.4))


def test_max_prob_is_prob_at_mean():
    cov = np.array([[1.5, 0.2], [0.2, 0.8]])
    mean = np.array([3.0, -1.0])
    mp = tg.max_prob(t(cov))
    assert np.isclose(float(mp), float(tg.gaussian_prob(*t(mean, cov, mean))),
                      rtol=1e-5)
    close(mp, jg.max_prob(cov))


def test_incremental_gaussian_uni_matches_batch_moments():
    rng = np.random.default_rng(2)
    xs = rng.normal(2.0, 1.5, size=32).astype(np.float32)
    ws = rng.uniform(0.5, 2.0, size=32).astype(np.float32)
    state = tg.incremental_gaussian_uni_init(device=CPU)
    jstate = jg.incremental_gaussian_uni_init()
    for w, x in zip(ws, xs):
        state = tg.incremental_gaussian_uni_add(state, *t(w, x))
        jstate = jg.incremental_gaussian_uni_add(jstate, w, x)
    mean = np.sum(ws * xs) / np.sum(ws)
    var = np.sum(ws * xs * xs) / np.sum(ws) - mean * mean
    assert np.isclose(float(tg.incremental_gaussian_uni_mean(state)), mean,
                      rtol=1e-4)
    assert np.isclose(float(tg.incremental_gaussian_uni_var(state)), var,
                      rtol=1e-3)
    # The same additions in the same order: equal.
    for a, b in zip(state, jstate):
        assert float(a) == float(b)


def test_incremental_gaussian_matches_reference_recursion():
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(16, 2)).astype(np.float32)
    ws = rng.uniform(0.1, 1.0, size=16).astype(np.float32)
    accum_w, accum_mean, accum_cov = 0.0, np.zeros(2), np.zeros((2, 2))
    mean = np.zeros(2)
    for w, x in zip(ws, xs):
        d = x - mean
        accum_mean = accum_mean + w * x
        accum_cov = accum_cov + w * np.outer(d, d)
        accum_w += w
        mean = accum_mean / accum_w
    state = tg.incremental_gaussian_init(2, device=CPU)
    jstate = jg.incremental_gaussian_init(2)
    for w, x in zip(ws, xs):
        state = tg.incremental_gaussian_add(state, *t(w, x))
        jstate = jg.incremental_gaussian_add(jstate, w, jnp.asarray(x))
    assert np.allclose(tg.incremental_gaussian_mean(state).numpy(), mean,
                       atol=1e-5)
    assert np.allclose(tg.incremental_gaussian_cov(state).numpy(),
                       accum_cov / accum_w, atol=1e-4)
    for a, b in zip(state, jstate):
        close(a, b)
    close(tg.incremental_gaussian_prob(state, t(xs[0])),
          jg.incremental_gaussian_prob(jstate, xs[0]))


def test_gaussian_estimater_matches_reference_recursion():
    P, mean, var = 1000.0, 0.0, 1.0
    state = tg.gaussian_estimater_init(device=CPU)
    jstate = jg.gaussian_estimater_init()
    rng = np.random.default_rng(4)
    for _ in range(20):
        w = rng.uniform(0.2, 1.0)
        f = rng.normal(3.0, 0.5)
        K = min(1.0 - 1e-6, w * P / (P + 0.01))
        mean = K * f + (1 - K) * mean
        var = K * (f - mean) ** 2 + (1 - K) * var
        P = (1 - K) * P
        state = tg.gaussian_estimater_update(state, *t(w, f))
        jstate = jg.gaussian_estimater_update(jstate, np.float32(w),
                                              np.float32(f))
    assert np.isclose(float(state.mean), mean, rtol=1e-4)
    assert np.isclose(float(state.var), var, rtol=1e-3)
    p = tg.gaussian_estimater_prob(state, t(mean))
    assert np.isclose(float(p), 1.0 / np.sqrt(2 * np.pi * var), rtol=1e-3)
    for a, b in zip(state, jstate):
        close(a, b)


def test_independent_gaussian_estimates_dimensions():
    rng = np.random.default_rng(5)
    xs = rng.normal([1.0, -2.0], [0.3, 0.6], size=(200, 2)).astype(
        np.float32)
    ones = np.ones(200, np.float32)
    state = tg.scan_add(tg.independent_gaussian_init(2, device=CPU),
                        tg.independent_gaussian_add, t(ones), t(xs))
    jstate = jg.scan_add(jg.independent_gaussian_init(2),
                         jg.independent_gaussian_add, ones, jnp.asarray(xs))
    assert np.allclose(state.mean.numpy(), [1.0, -2.0], atol=0.15)
    d2 = tg.independent_gaussian_mahalanobis_sq(state, state.mean)
    assert float(d2) < 1e-6
    assert float(tg.independent_gaussian_prob(state, state.mean)) > 0
    for a, b in zip(state, jstate):
        close(a, b)
    q = np.array([0.5, -1.0], np.float32)
    close(tg.independent_gaussian_prob(state, t(q)),
          jg.independent_gaussian_prob(jstate, q))
    close(tg.independent_gaussian_mahalanobis_sq(state, t(q)),
          jg.independent_gaussian_mahalanobis_sq(jstate, q))


def test_gmm_prob():
    w, means, variances = (np.array(v, np.float32) for v in (
        [0.3, 0.7], [0.0, 4.0], [1.0, 1.0]))
    p = tg.gmm_prob_uni(*t(w, means, variances, 0.0))
    expected = 0.3 / np.sqrt(2 * np.pi) + 0.7 * float(
        tg.gaussian_prob_uni(*t(4.0, 1.0, 0.0)))
    assert np.isclose(float(p), expected, rtol=1e-5)
    close(p, jg.gmm_prob_uni(w, means, variances, 0.0))
    mmeans = np.zeros((2, 2), np.float32)
    mmeans[1] = 4.0
    covs = np.broadcast_to(np.eye(2, dtype=np.float32), (2, 2, 2))
    p2 = tg.gmm_prob(*t(w, mmeans, covs, np.zeros(2)))
    assert float(p2) > 0.3 / (2 * np.pi) * 0.99
    close(p2, jg.gmm_prob(w, mmeans, covs, jnp.zeros(2)))
    xq = np.random.default_rng(13).normal(size=(5, 2)).astype(np.float32)
    close(tg.gmm_prob(*t(w, mmeans, covs, xq)),
          jg.gmm_prob(w, mmeans, covs, xq))
    close(tg.gaussian_cumulative_prob_uni(*t(1.0, 2.0, xq[:, 0])),
          jg.gaussian_cumulative_prob_uni(1.0, 2.0, xq[:, 0]))


# ---------------------------------------------------------------------------
# classifiers
# ---------------------------------------------------------------------------


def _two_cluster_knn(capacity=32):
    """The same 20 points in both packages' stores."""
    rng = np.random.default_rng(6)
    state = tc.knn_init(capacity, 2, device=CPU)
    jstate = jc.knn_init(capacity, 2)
    for _ in range(10):
        for label, c in ((1, 2.0), (0, -2.0)):
            p = rng.normal([c, c], 0.2).astype(np.float32)
            state = tc.knn_add(state, label, t(p))
            jstate = jc.knn_add(jstate, label, jnp.asarray(p))
    return state, jstate


def _same_store(state, jstate):
    for a, b in zip(state, jstate):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_knn_predict_majority():
    state, jstate = _two_cluster_knn()
    _same_store(state, jstate)
    for q, want in (([2.0, 1.8], 1), ([-2.0, -1.8], 0), ([0.1, -0.1], None)):
        got = int(tc.knn_predict(state, t(q)))
        assert got == int(jc.knn_predict(jstate, jnp.asarray(q)))
        assert want is None or got == want


def test_knn_predict_binary_and_confidence():
    state, jstate = _two_cluster_knn()
    is_pos, d = tc.knn_predict_binary(state, t([2.0, 2.0]))
    assert bool(is_pos) and float(d) < 1.0
    j_pos, jd = jc.knn_predict_binary(jstate, jnp.asarray([2.0, 2.0]))
    assert bool(is_pos) == bool(j_pos) and float(d) == float(jd)
    conf, _ = tc.knn_predict_binary_real(state, t([2.0, 2.0]), k=5)
    assert 0.0 < float(conf) <= 1.0
    conf_neg, _ = tc.knn_predict_binary_real(state, t([-2.0, -2.0]), k=5)
    assert -1.0 <= float(conf_neg) < 0.0
    for q in ([2.0, 2.0], [-2.0, -2.0], [0.3, 0.2]):
        c, dd = tc.knn_predict_binary_real(state, t(q), k=5)
        jc_, jdd = jc.knn_predict_binary_real(jstate, jnp.asarray(q), k=5)
        assert (float(c), float(dd)) == (float(jc_), float(jdd))


def test_knn_ring_wraps():
    state = tc.knn_init(4, 1, device=CPU)
    jstate = jc.knn_init(4, 1)
    for i in range(6):
        state = tc.knn_add(state, i, t([float(i)]))
        jstate = jc.knn_add(jstate, i, jnp.asarray([float(i)]))
    _same_store(state, jstate)
    assert int(state.count) == 6
    lbl = tc.knn_predict(state, t([5.0]), k=1, min_label=0, max_label=5)
    assert int(lbl) == 5
    # Equal distances (4.0 lies between 3 and 5): the lower slot first in
    # both packages, so the vote goes to the same label.
    for k in (1, 2, 3):
        assert int(tc.knn_predict(state, t([4.0]), k=k, max_label=5)) == \
            int(jc.knn_predict(jstate, jnp.asarray([4.0]), k=k,
                               max_label=5))
    labels, sq = tc._knn_neighbors(state, t([4.0]), 4)
    jl, jsq = jc._knn_neighbors(jstate, jnp.asarray([4.0]), 4)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(sq.numpy(), np.asarray(jsq))


def test_knn_empty_returns_min_label():
    state = tc.knn_init(8, 2, device=CPU)
    lbl = tc.knn_predict(state, t([0.0, 0.0]), min_label=3, max_label=5)
    assert int(lbl) == 3
    assert int(lbl) == int(jc.knn_predict(jc.knn_init(8, 2), jnp.zeros(2),
                                          min_label=3, max_label=5))


def test_incremental_nb_separates():
    rng = np.random.default_rng(7)
    state = tc.incremental_nb_init(device=CPU)
    jstate = jc.incremental_nb_init()
    for _ in range(50):
        for label, c in ((1.0, 2.0), (-1.0, -2.0)):
            x = np.float32(rng.normal(c, 0.4))
            state = tc.incremental_nb_add(state, *t(label, x))
            jstate = jc.incremental_nb_add(jstate, label, x)
    assert int(tc.incremental_nb_predict(state, t(1.8))) == 1
    assert int(tc.incremental_nb_predict(state, t(-1.8))) == -1
    for a, b in zip(_leaves(state), _leaves(jstate)):
        close(a, b, rtol=1e-4)
    for q in (1.8, -1.8, 0.05):
        close(tc.incremental_nb_predict_real(state, t(q)),
              jc.incremental_nb_predict_real(jstate, q), rtol=1e-4)


def test_independent_nb_sub_indices():
    rng = np.random.default_rng(8)
    state = tc.independent_nb_init(3, sub_indices=[2], device=CPU)
    jstate = jc.independent_nb_init(3, sub_indices=[2])
    for _ in range(60):
        pos = np.array([rng.normal(), rng.normal(), rng.normal(1.5, 0.3)],
                       np.float32)
        neg = np.array([rng.normal(), rng.normal(), rng.normal(-1.5, 0.3)],
                       np.float32)
        for label, x in ((1.0, pos), (-1.0, neg)):
            state = tc.independent_nb_update(state, label, t(x))
            jstate = jc.independent_nb_update(jstate, label,
                                              jnp.asarray(x))
    q_pos = np.array([5.0, -5.0, 1.4], np.float32)
    q_neg = np.array([5.0, -5.0, -1.4], np.float32)
    assert int(tc.independent_nb_predict(state, t(q_pos))) == 1
    assert int(tc.independent_nb_predict(state, t(q_neg))) == -1
    for q in (q_pos, q_neg):
        close(tc.independent_nb_predict_real(state, t(q)),
              jc.independent_nb_predict_real(jstate, q), rtol=1e-4)
    for a, b in zip(_leaves(state), _leaves(jstate)):
        close(a, b, rtol=1e-5)


# ---------------------------------------------------------------------------
# boosting
# ---------------------------------------------------------------------------


def test_online_boosting_learns_separable():
    rng = np.random.default_rng(9)
    state = tb.online_boosting_init(n_selectors=4, n_weak=3, dim=2,
                                    subset_size=2, seed=0, device=CPU)
    jstate = jb.online_boosting_init(n_selectors=4, n_weak=3, dim=2,
                                     subset_size=2, seed=0)
    np.testing.assert_array_equal(state.weak.sub_indices.numpy(),
                                  np.asarray(jstate.weak.sub_indices))
    jupdate = jax.jit(jb.online_boosting_update)
    for _ in range(80):
        for label, c in ((1.0, 1.5), (-1.0, -1.5)):
            x = rng.normal([c, c], 0.3).astype(np.float32)
            state = tb.online_boosting_update(state, label, t(x))
            jstate = jupdate(jstate, label, jnp.asarray(x))
    assert int(tb.online_boosting_predict(state, t([1.4, 1.4]))) == 1
    assert int(tb.online_boosting_predict(state, t([-1.4, -1.4]))) == -1
    conf = float(tb.online_boosting_predict_real(state, t([1.4, 1.4])))
    assert 0.0 < conf < 1.0
    # 160 updates through the estimator recursions: the correct / wrong
    # accumulators within 1e-4 relative, the confidence within 1e-5.
    close(state.lambda_corr, jstate.lambda_corr, rtol=1e-4)
    close(state.lambda_wrong, jstate.lambda_wrong, rtol=1e-4)
    for q in ([1.4, 1.4], [-1.4, -1.4], [0.2, -0.3]):
        close(tb.online_boosting_predict_real(state, t(q)),
              jb.online_boosting_predict_real(jstate, jnp.asarray(q)),
              rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# icf
# ---------------------------------------------------------------------------


def test_integral_box_filter_matches_numpy_mean():
    rng = np.random.default_rng(10)
    img = rng.uniform(size=(40, 60)).astype(np.float32)
    integ = ti.integral_image(t(img))
    jinteg = ji.integral_image(jnp.asarray(img))
    close(integ, jinteg, rtol=1e-6)  # 2,400-term f32 prefix sums
    x0, y0 = int(0.25 * 60), int(0.5 * 40)
    w, h = int(0.5 * 60), int(0.25 * 40)
    expected = img[y0:y0 + h, x0:x0 + w].mean()
    got = float(ti.box_filter(integ, (0.25, 0.5), (0.5, 0.25)))
    assert np.isclose(got, expected, rtol=1e-4)
    # The same integral image in both: equal to the last bit.
    assert got == float(ji.box_filter(jnp.asarray(integ.numpy()),
                                      (0.25, 0.5), (0.5, 0.25)))


def test_box_filter_small_rect_is_zero():
    integ = ti.integral_image(torch.ones(40, 60))
    assert float(ti.box_filter(integ, (0.0, 0.0), (0.02, 0.5))) == 0.0
    assert float(ji.box_filter(ji.integral_image(jnp.ones((40, 60))),
                               (0.0, 0.0), (0.02, 0.5))) == 0.0


def test_box_filter_bank_and_channel_axis():
    rng = np.random.default_rng(11)
    img = rng.uniform(size=(3, 32, 32)).astype(np.float32)
    integ = ti.integral_image(t(img))
    tls = [(0.0, 0.0), (0.5, 0.5), (0.1, 0.7), (0.9, 0.9)]
    sizes = [(0.5, 0.5), (0.5, 0.5), (0.3, 0.2), (0.05, 0.5)]
    out = ti.box_filter_bank(integ, tls, sizes)
    assert tuple(out.shape) == (4, 3)
    assert np.isclose(float(out[0, 1]), img[1, :16, :16].mean(), rtol=1e-4)
    ref = ji.box_filter_bank(jnp.asarray(integ.numpy()), tls, sizes)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_extract_hsv_known_colors():
    rgb = np.array([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.5, 0.5, 0.5]]],
                   np.float32)
    h, s, v = ti.extract_hsv(t(rgb)).numpy()
    assert np.isclose(h[0, 0], 0.0)
    assert np.isclose(h[0, 1], 60.0)
    assert np.isclose(s[0, 0], 255.0)
    assert np.isclose(s[0, 2], 0.0)
    assert np.isclose(v[0, 2], 127.5)
    rand = np.random.default_rng(14).uniform(size=(9, 11, 3)).astype(
        np.float32)
    for x in (rgb, rand):
        close(ti.extract_hsv(t(x)), ji.extract_hsv(jnp.asarray(x)), rtol=0,
              atol=1e-4)  # hue in [0, 180): a few f32 ulps


def test_extract_luv_white_and_range():
    l_, u, v = ti.extract_luv(torch.ones(2, 2, 3)).numpy()
    assert np.allclose(l_, 255.0, atol=1.0)
    assert np.all((u >= 0) & (u <= 255)) and np.all((v >= 0) & (v <= 255))
    rand = np.random.default_rng(15).uniform(size=(9, 11, 3)).astype(
        np.float32)
    rand[0, 0] = 0.0  # black: the linear branch of L*
    for x in (np.ones((2, 2, 3), np.float32), rand):
        # pow and cube root in another library: within 1e-3 on [0, 255].
        close(ti.extract_luv(t(x)), ji.extract_luv(jnp.asarray(x)), rtol=0,
              atol=1e-3)


def test_extract_grads_vertical_edge():
    img = np.concatenate([np.zeros((8, 8)), np.ones((8, 8))], 1)
    ch = ti.extract_grads(t(img), n_bins=6).numpy()
    assert ch.shape == (7, 8, 16)
    col = 7
    assert ch[0, 4, col] > 0
    assert np.allclose(ch[1:6, 4, col], 0.0)
    assert np.isclose(ch[6, 4, col], ch[0, 4, col])
    np.testing.assert_array_equal(
        ch, np.asarray(ji.extract_grads(jnp.asarray(img, jnp.float32),
                                        n_bins=6)))


def test_default_channel_bank_shape():
    rng = np.random.default_rng(12)
    rgb = rng.uniform(size=(16, 20, 3)).astype(np.float32)
    out = ti.default_channel_bank()(t(rgb))
    assert tuple(out.shape) == (13, 16, 20)
    assert bool(torch.isfinite(out).all())
    ref = np.asarray(ji.default_channel_bank()(jnp.asarray(rgb)))
    close(out[:6], ref[:6], rtol=0, atol=1e-3)  # HSV, LUV as above
    # Gradients: the same orientation bin at every pixel, magnitudes to
    # f32 rounding.
    np.testing.assert_array_equal(out[6:12].numpy() > 0, ref[6:12] > 0)
    close(out[6:], ref[6:], rtol=0, atol=1e-5)


def test_palette_and_rect_utils():
    pal = ti.create_color_palette(8)
    assert pal.shape == (8, 3)
    assert pal.min() >= 0.0 and pal.max() <= 255.0
    assert len({tuple(np.round(c, 3)) for c in pal}) == 8
    np.testing.assert_array_equal(pal, ji.create_color_palette(8))
    assert ti.clip_roi((-5, -5, 20, 20), (12, 10)) == (0, 0, 12, 10)
    assert ti.enlarge_rect((10, 10, 10, 10), 2.0) == (5.0, 5.0, 20.0, 20.0)
    assert ti.shift_rect((1, 2, 3, 4), (10, 20)) == (11, 22, 3, 4)
    for f, args in ((ti.clip_roi, ((3, -2, 20, 9), (12, 10))),
                    (ti.enlarge_rect, ((4, 6, 10, 8), 1.5)),
                    (ti.shift_rect, ((1, 2, 3, 4), (-1, 5)))):
        assert f(*args) == getattr(ji, f.__name__)(*args)
