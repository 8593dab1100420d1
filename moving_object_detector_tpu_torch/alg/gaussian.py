"""Gaussian math toolkit (the JAX package's ``alg/gaussian.py``,
kkl/math/gaussian.hpp).

Scalar ("uni") and multivariate densities, Mahalanobis distances,
divergences, batch fitting, and the three stateful estimators as
functional states: ``*_init`` makes the state, ``*_add`` / ``*_update``
returns a NEW state, queries are pure. Functions broadcast over leading
batch axes where noted and compute in f32 on the device of their tensor
arguments (Python numbers follow them); with no tensor argument they run
on ``cuda``, or raise without it. Inits take a ``device``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import resolve_device


def _device(*args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(None)


def _f32(*args):
    """The arguments as f32 tensors on the device of the first tensor."""
    dev = _device(*args)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in args)


# ---------------------------------------------------------------------------
# Densities and distances
# ---------------------------------------------------------------------------

def gaussian_prob_uni(mean, var, x):
    """Scalar normal density N(x; mean, var) (gaussian.hpp:35-38).
    Elementwise over broadcast arguments."""
    mean, var, x = _f32(mean, var, x)
    d = x - mean
    return torch.exp(-(d * d) / (2.0 * var)) / torch.sqrt(2.0 * math.pi
                                                          * var)


def _solve(cov, d):
    """cov^-1 d for (..., p, p) and (..., p), broadcast."""
    return torch.linalg.solve(cov, d.unsqueeze(-1)).squeeze(-1)


def gaussian_prob(mean, cov, x):
    """Multivariate normal density (gaussianProbMul, gaussian.hpp:44-51).

    ``mean`` / ``x``: (..., p); ``cov``: (..., p, p). A solve in place of
    the reference's explicit inverse (same value, better conditioned)."""
    mean, cov, x = _f32(mean, cov, x)
    p = mean.shape[-1]
    d = x - mean
    quad = torch.sum(d * _solve(cov, d), dim=-1)
    norm = (2.0 * math.pi) ** (p / 2.0) * torch.sqrt(torch.linalg.det(cov))
    return torch.exp(-0.5 * quad) / norm


def gaussian_cumulative_prob_uni(mean, var, x):
    """Normal CDF (gaussian.hpp:57-59, the boost::math::erf variant)."""
    mean, var, x = _f32(mean, var, x)
    return 0.5 * (1.0 + torch.special.erf((x - mean) / torch.sqrt(2.0
                                                                   * var)))


def squared_mahalanobis(mean, cov, x):
    """(x-mean)^T cov^-1 (x-mean) (gaussian.hpp:66-71); batched like
    :func:`gaussian_prob`."""
    mean, cov, x = _f32(mean, cov, x)
    d = x - mean
    return torch.sum(d * _solve(cov, d), dim=-1)


def squared_mahalanobis_uni(mean, var, x):
    """Scalar Mahalanobis^2 (gaussian.hpp:77-80)."""
    mean, var, x = _f32(mean, var, x)
    d = mean - x
    return d * d / var


def kl_divergence_uni(mean_p, var_p, mean_q, var_q):
    """KL(N_p || N_q), scalar case (gaussian.hpp:126-128)."""
    mean_p, var_p, mean_q, var_q = _f32(mean_p, var_p, mean_q, var_q)
    dm = mean_p - mean_q
    return (torch.log(torch.sqrt(var_q / var_p))
            + (var_p + dm * dm) / (2.0 * var_q) - 0.5)


def kl_divergence(mean_p, cov_p, mean_q, cov_q):
    """KL(N_p || N_q), multivariate (klDivergenceMul,
    gaussian.hpp:134-140)."""
    mean_p, cov_p, mean_q, cov_q = _f32(mean_p, cov_p, mean_q, cov_q)
    p = mean_p.shape[-1]
    dm = mean_p - mean_q
    trace = torch.linalg.solve(cov_q, cov_p).diagonal(
        dim1=-2, dim2=-1).sum(-1)
    quad = torch.sum(dm * _solve(cov_q, dm), dim=-1)
    logdet = torch.log(torch.linalg.det(cov_q) / torch.linalg.det(cov_p))
    return 0.5 * (logdet + trace + quad - p)


def l2_distance_uni(mean_p, var_p, mean_q, var_q):
    """Closed-form L2 distance between scalar normal densities
    (gaussian.hpp:146-155)."""
    mean_p, var_p, mean_q, var_q = _f32(mean_p, var_p, mean_q, var_q)
    mean = (var_q * mean_p + var_p * mean_q) / (var_p + var_q)
    var = (var_p * var_q) / (var_p + var_q)
    a = mean * mean - (var_q * mean_p * mean_p
                       + var_p * mean_q * mean_q) / (var_p + var_q)
    return (1.0 / (2.0 * torch.sqrt(math.pi * var_p))
            + 1.0 / (2.0 * torch.sqrt(math.pi * var_q))
            - torch.sqrt(2.0 * math.pi * var)
            / (math.pi * torch.sqrt(var_p * var_q))
            * torch.exp(a / (2.0 * var)))


def fit_gaussian(data, weights=None):
    """Batch-fit (mean, cov) with 1/N normalization (fitGaussian,
    gaussian.hpp:88-99). ``data``: (n, p); optional ``weights``: (n,),
    the fixed-shape substitute for the reference's growable input."""
    (data,) = _f32(data)
    if weights is None:
        weights = torch.ones(data.shape[0], device=data.device)
    weights = torch.as_tensor(weights, dtype=torch.float32,
                              device=data.device)
    wsum = torch.sum(weights)
    mean = torch.sum(weights[:, None] * data, dim=0) / wsum
    d = data - mean
    cov = (weights[:, None] * d).T @ d / wsum
    return mean, cov


def max_prob(cov):
    """Density at the mean (GaussianDistribution::maxProb,
    gaussian.hpp:252-254). Frozen distributions are (mean, cov) argument
    pairs here: ``gaussian_prob`` and ``squared_mahalanobis`` are their
    ``prob`` / ``mahalanobisDistance``."""
    (cov,) = _f32(cov)
    p = cov.shape[-1]
    return 1.0 / ((2.0 * math.pi) ** (p / 2.0)
                  * torch.sqrt(torch.linalg.det(cov)))


# ---------------------------------------------------------------------------
# IncrementalGaussianDistribution (gaussian.hpp:283-478)
# ---------------------------------------------------------------------------


class IncrementalGaussian(NamedTuple):
    """Weighted streaming mean / covariance accumulator state."""

    accum_w: torch.Tensor     # scalar
    accum_mean: torch.Tensor  # (p,) == sum w_i x_i
    accum_cov: torch.Tensor   # (p, p) == sum w_i (x_i - mean_before) d^T


def incremental_gaussian_init(dim: int, device=None) -> IncrementalGaussian:
    """Zero state (IncrementalGaussianDistribution ctor,
    gaussian.hpp:299-316)."""
    dev = resolve_device(device)
    return IncrementalGaussian(
        accum_w=torch.zeros((), device=dev),
        accum_mean=torch.zeros((dim,), device=dev),
        accum_cov=torch.zeros((dim, dim), device=dev))


def incremental_gaussian_add(state: IncrementalGaussian, w, x):
    """Add a weighted sample (add, gaussian.hpp:355-366), with the
    reference's PRE-update mean in the covariance rank-1 term."""
    w, x = _f32(w, x)
    mean_before = torch.where(state.accum_w > 0,
                              state.accum_mean / state.accum_w, 0.0)
    d = x - mean_before
    return IncrementalGaussian(
        accum_w=state.accum_w + w,
        accum_mean=state.accum_mean + w * x,
        accum_cov=state.accum_cov + w * torch.outer(d, d))


def incremental_gaussian_mean(state: IncrementalGaussian):
    return state.accum_mean / state.accum_w


def incremental_gaussian_cov(state: IncrementalGaussian):
    """Lazy covariance (update, gaussian.hpp:443-452)."""
    return state.accum_cov / state.accum_w


def incremental_gaussian_prob(state: IncrementalGaussian, x):
    return gaussian_prob(incremental_gaussian_mean(state),
                         incremental_gaussian_cov(state), x)


class IncrementalGaussianUni(NamedTuple):
    """Scalar streaming accumulator (IncrementalGaussianDistributionUni,
    gaussian.hpp:480-528): weighted first / second moments."""

    accum_w: torch.Tensor
    accum_wx: torch.Tensor
    accum_wx_sq: torch.Tensor


def incremental_gaussian_uni_init(device=None) -> IncrementalGaussianUni:
    z = torch.zeros((), device=resolve_device(device))
    return IncrementalGaussianUni(z, z, z)


def incremental_gaussian_uni_add(state: IncrementalGaussianUni, w, x):
    w, x = _f32(state.accum_w, w, x)[1:]
    return IncrementalGaussianUni(
        accum_w=state.accum_w + w,
        accum_wx=state.accum_wx + w * x,
        accum_wx_sq=state.accum_wx_sq + w * x * x)


def incremental_gaussian_uni_mean(state: IncrementalGaussianUni):
    return state.accum_wx / state.accum_w


def incremental_gaussian_uni_var(state: IncrementalGaussianUni):
    m = incremental_gaussian_uni_mean(state)
    return state.accum_wx_sq / state.accum_w - m * m


def incremental_gaussian_uni_prob(state: IncrementalGaussianUni, x):
    return gaussian_prob_uni(incremental_gaussian_uni_mean(state),
                             incremental_gaussian_uni_var(state), x)


# ---------------------------------------------------------------------------
# Mixture models (GaussianMixtureModel(Uni), gaussian.hpp:530-646):
# stacked-component tensors instead of vectors of objects.
# ---------------------------------------------------------------------------


def gmm_prob_uni(weights, means, variances, x):
    """sum_k w_k N(x; mu_k, var_k); components on the leading axis of the
    (k,) parameter tensors, ``x`` any shape (broadcast against
    components)."""
    weights, means, variances, x = _f32(weights, means, variances, x)
    comp = gaussian_prob_uni(means, variances, x[..., None])
    return torch.sum(weights * comp, dim=-1)


def gmm_prob(weights, means, covs, x):
    """Multivariate mixture density; ``means``: (k, p), ``covs``:
    (k, p, p), ``x``: (..., p)."""
    weights, means, covs, x = _f32(weights, means, covs, x)
    comp = gaussian_prob(means, covs, x[..., None, :])
    return torch.sum(weights * comp, dim=-1)


# ---------------------------------------------------------------------------
# GaussianEstimater (gaussian.hpp:648-698): scalar Kalman-style recursive
# estimator with fixed measurement noise R = 0.01.
# ---------------------------------------------------------------------------


class GaussianEstimater(NamedTuple):
    P: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor


def gaussian_estimater_init(init_mean=0.0, init_var=1.0, init_p=1000.0,
                            device=None) -> GaussianEstimater:
    dev = resolve_device(device)
    return GaussianEstimater(
        *(torch.tensor(v, dtype=torch.float32, device=dev)
          for v in (init_p, init_mean, init_var)))


def gaussian_estimater_update(state: GaussianEstimater, w, f):
    """update (gaussian.hpp:669-675): gain-clamped recursive mean / var.
    The variance innovation uses the POST-update mean, as the reference
    does."""
    w, f = _f32(state.P, w, f)[1:]
    k = torch.clamp(w * state.P / (state.P + 0.01), max=1.0 - 1e-6)
    mean = k * f + (1.0 - k) * state.mean
    var = k * (f - mean) ** 2 + (1.0 - k) * state.var
    return GaussianEstimater(P=(1.0 - k) * state.P, mean=mean, var=var)


def gaussian_estimater_prob(state: GaussianEstimater, f):
    return gaussian_prob_uni(state.mean, state.var, f)


# ---------------------------------------------------------------------------
# IndependentGaussianEstimater (gaussian.hpp:700-755): per-dimension
# independent recursive estimator ("On-line Boosting and Vision"). The
# functions broadcast over leading estimator axes: P and R (...,), mean and
# var (..., p).
# ---------------------------------------------------------------------------


class IndependentGaussianEstimater(NamedTuple):
    P: torch.Tensor     # scalar
    R: torch.Tensor     # scalar process noise
    mean: torch.Tensor  # (p,)
    var: torch.Tensor   # (p,)


def independent_gaussian_init(dim: int, process_noise=0.01, init_mean=None,
                              init_var=None, init_p=1000.0,
                              device=None) -> IndependentGaussianEstimater:
    dev = resolve_device(device)

    def vec(v, fill):
        if v is None:
            return torch.full((dim,), fill, device=dev)
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    return IndependentGaussianEstimater(
        P=torch.tensor(init_p, dtype=torch.float32, device=dev),
        R=torch.tensor(process_noise, dtype=torch.float32, device=dev),
        mean=vec(init_mean, 0.0), var=vec(init_var, 1.0))


def independent_gaussian_add(state: IndependentGaussianEstimater, w, x):
    """add (gaussian.hpp:725-731): the post-update-mean recursion of
    GaussianEstimater per dimension, with configurable process noise and
    a gain clamped to 1.0."""
    w, x = _f32(state.P, w, x)[1:]
    k = torch.clamp(state.P / (state.P + state.R) * w, max=1.0)
    kd = k.unsqueeze(-1)
    mean = kd * x + (1.0 - kd) * state.mean
    var = kd * (x - mean) ** 2 + (1.0 - kd) * state.var
    return state._replace(P=(1.0 - k) * state.P, mean=mean, var=var)


def independent_gaussian_mahalanobis_sq(state: IndependentGaussianEstimater,
                                        x):
    (x,) = _f32(x)
    return torch.sum((x - state.mean) ** 2 / state.var, dim=-1)


def independent_gaussian_prob(state: IndependentGaussianEstimater, x):
    """Product of per-dimension densities (gaussian.hpp:740-744)."""
    return torch.prod(gaussian_prob_uni(state.mean, state.var, x), dim=-1)


def scan_add(init_state, add_fn, weights, xs):
    """Fold a batch of weighted samples through any of the ``*_add``
    updaters, in order (the reference's per-sample method-call loop)."""
    state = init_state
    for w, x in zip(weights, xs):
        state = add_fn(state, w, x)
    return state
