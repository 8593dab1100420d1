"""Online classifiers (the JAX package's ``alg/classifiers.py``,
kkl/ml/{flann_knn_classifier, incremental_naive_bayes,
independent_naive_bayes}.hpp).

All three are fixed-shape functional states:

* :class:`KNNClassifier`: the FLANN linear-index kNN classifier
  (flann_knn_classifier.hpp:23-180) as a fixed-capacity ring buffer of
  (point, label) rows plus a dense L2 row and ``torch.topk`` per query:
  brute force is the device's index for any capacity that fits on it.
* ``incremental_nb_*``: scalar two-class naive Bayes over two recursive
  GaussianEstimaters (incremental_naive_bayes.hpp:9-46).
* ``independent_nb_*``: vector two-class naive Bayes over per-dimension
  IndependentGaussianEstimaters with an optional static feature-subset
  view (independent_naive_bayes.hpp:16-150). They broadcast over leading
  classifier axes (``alg/boosting.py`` stacks them (S, M)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from .gaussian import (
    GaussianEstimater,
    IndependentGaussianEstimater,
    _f32,
    gaussian_estimater_init,
    gaussian_estimater_prob,
    gaussian_estimater_update,
    independent_gaussian_add,
    independent_gaussian_init,
    independent_gaussian_prob,
)

# ---------------------------------------------------------------------------
# kNN classifier (FLANN linear index -> dense distances + top-k)
# ---------------------------------------------------------------------------


class KNNClassifier(NamedTuple):
    """Fixed-capacity sample store. ``count`` grows monotonically; once
    past capacity the write cursor wraps (ring); the reference grows
    without bound, which has no fixed-shape equivalent."""

    points: torch.Tensor  # (capacity, p)
    labels: torch.Tensor  # (capacity,) int32
    count: torch.Tensor   # scalar int32, total points ever added


def knn_init(capacity: int, dim: int, device=None) -> KNNClassifier:
    dev = resolve_device(device)
    return KNNClassifier(
        points=torch.zeros((capacity, dim), device=dev),
        labels=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev))


def knn_add(state: KNNClassifier, label, point) -> KNNClassifier:
    """addPoint (flann_knn_classifier.hpp:40-52); the slot is computed on
    the device, so adding does not wait for it."""
    cap = state.points.shape[0]
    slot = torch.remainder(state.count, cap).reshape(1).long()
    (point,) = _f32(state.points, point)[1:]
    label = torch.as_tensor(label, dtype=torch.int32,
                            device=state.labels.device)
    return KNNClassifier(
        points=state.points.index_copy(0, slot, point.reshape(1, -1)),
        labels=state.labels.index_copy(0, slot, label.reshape(1)),
        count=state.count + 1)


def _knn_neighbors(state: KNNClassifier, query, k: int):
    """Top-k nearest valid rows: (labels, sq_dists), nearest first. Empty
    slots get +inf distance so they never vote (the reference errors on
    an empty index).

    Equal distances come lowest index first, as ``lax.top_k`` orders
    them: the top-k runs on int64 keys (the f32 distance's bits, which
    order like the value for non-negative floats, above the slot index),
    so every key is distinct."""
    cap = state.points.shape[0]
    idx = torch.arange(cap, device=state.points.device)
    (query,) = _f32(state.points, query)[1:]
    d = query[None, :] - state.points
    sq = torch.sum(d * d, dim=-1)
    sq = torch.where(idx < state.count, sq, torch.inf)
    keys = (sq.view(torch.int32).to(torch.int64) << 32) | idx
    _, order = torch.topk(keys, k, largest=False)
    return state.labels[order], sq[order]


def knn_predict(state: KNNClassifier, query, k: int = 5, min_label: int = 0,
                max_label: int = 1):
    """Majority-vote label over the k nearest points (predict,
    flann_knn_classifier.hpp:57-84); the first of tied labels wins. The
    label range is static (a fixed one-hot width) where the reference
    tracks min / max as it goes."""
    labels, sq = _knn_neighbors(state, query, k)
    votable = torch.isfinite(sq)
    n_labels = max_label - min_label + 1
    one_hot = (labels[:, None] - min_label) == torch.arange(
        n_labels, device=labels.device)
    hist = torch.sum(one_hot & votable[:, None], dim=0)
    return (min_label + torch.argmax(hist)).to(torch.int32)


def knn_predict_binary(state: KNNClassifier, query, k: int = 5):
    """(is_positive, min_sq_dist) (predictBinary,
    flann_knn_classifier.hpp:90-119): positive iff pos votes > neg
    votes."""
    labels, sq = _knn_neighbors(state, query, k)
    votable = torch.isfinite(sq)
    pos = torch.sum((labels > 0) & votable)
    neg = torch.sum((labels <= 0) & votable)
    return pos > neg, sq[0]


def knn_predict_binary_real(state: KNNClassifier, query, k: int = 5):
    """Signed confidence in (0, 1] (predictBinaryReal,
    flann_knn_classifier.hpp:126-160): sign = majority, magnitude =
    (max_votes - floor((k-1)/2)) / (k - floor((k-1)/2))."""
    labels, sq = _knn_neighbors(state, query, k)
    votable = torch.isfinite(sq)
    pos = torch.sum((labels > 0) & votable)
    neg = torch.sum((labels <= 0) & votable)
    sign = torch.where(pos > neg, 1.0, -1.0)
    half = (k - 1) // 2
    conf = (torch.maximum(pos, neg) - half) / float(k - half)
    return sign * conf, sq[0]


# ---------------------------------------------------------------------------
# IncrementalNaiveBayes (scalar feature, incremental_naive_bayes.hpp)
# ---------------------------------------------------------------------------


class IncrementalNB(NamedTuple):
    pos_w: torch.Tensor
    neg_w: torch.Tensor
    pos: GaussianEstimater
    neg: GaussianEstimater


def incremental_nb_init(device=None) -> IncrementalNB:
    dev = resolve_device(device)
    return IncrementalNB(
        pos_w=torch.tensor(1e-6, device=dev),
        neg_w=torch.tensor(1e-6, device=dev),
        pos=gaussian_estimater_init(device=dev),
        neg=gaussian_estimater_init(device=dev))


def _split_weight(label):
    """(w if positive else 0, 0 if positive else w) for a signed label
    whose magnitude is the weight: the untouched class gets a zero-weight
    update, which is exactly a no-op in the estimator recursion."""
    w = torch.abs(label)
    is_pos = label > 0
    zero = torch.zeros_like(w)
    return torch.where(is_pos, w, zero), torch.where(is_pos, zero, w)


def incremental_nb_add(state: IncrementalNB, label, x) -> IncrementalNB:
    """add (incremental_naive_bayes.hpp:16-24): the signed ``label`` is
    the weight; positive updates the pos class, else the neg class."""
    label, x = _f32(state.pos_w, label, x)[1:]
    w_pos, w_neg = _split_weight(label)
    return IncrementalNB(
        pos_w=state.pos_w + w_pos, neg_w=state.neg_w + w_neg,
        pos=gaussian_estimater_update(state.pos, w_pos, x),
        neg=gaussian_estimater_update(state.neg, w_neg, x))


def incremental_nb_predict_real(state: IncrementalNB, x):
    """Posterior difference (predict_real,
    incremental_naive_bayes.hpp:30-40)."""
    total = state.pos_w + state.neg_w
    return (state.pos_w / total * gaussian_estimater_prob(state.pos, x)
            - state.neg_w / total * gaussian_estimater_prob(state.neg, x))


def incremental_nb_predict(state: IncrementalNB, x):
    """+1 / -1 (predict, incremental_naive_bayes.hpp:26-28)."""
    return torch.where(incremental_nb_predict_real(state, x) > 0, 1,
                       -1).to(torch.int32)


# ---------------------------------------------------------------------------
# IndependentNaiveBayes (vector feature, independent_naive_bayes.hpp)
# ---------------------------------------------------------------------------


class IndependentNB(NamedTuple):
    pos_w: torch.Tensor
    neg_w: torch.Tensor
    pos: IndependentGaussianEstimater
    neg: IndependentGaussianEstimater
    # Static feature-subset view (sub_indices,
    # independent_naive_bayes.hpp:32-38,135-142); all features by default.
    sub_indices: torch.Tensor


def independent_nb_init(dim: int, sub_indices=None,
                        device=None) -> IndependentNB:
    dev = resolve_device(device)
    if sub_indices is not None:
        sub_indices = torch.as_tensor(sub_indices, dtype=torch.int64,
                                      device=dev)
        dim = int(sub_indices.shape[-1])
    else:
        sub_indices = torch.arange(dim, device=dev)
    return IndependentNB(
        pos_w=torch.tensor(1e-3, device=dev),
        neg_w=torch.tensor(1e-3, device=dev),
        pos=independent_gaussian_init(dim, device=dev),
        neg=independent_gaussian_init(dim, device=dev),
        sub_indices=sub_indices)


def _sub(state: IndependentNB, x):
    (x,) = _f32(state.pos_w, x)[1:]
    return x[state.sub_indices]


def independent_nb_update(state: IndependentNB, label,
                          x) -> IndependentNB:
    """update / add_impl (independent_naive_bayes.hpp:44-51,93-103)."""
    f = _sub(state, x)
    (label,) = _f32(state.pos_w, label)[1:]
    w_pos, w_neg = _split_weight(label)
    return state._replace(
        pos_w=state.pos_w + w_pos, neg_w=state.neg_w + w_neg,
        pos=independent_gaussian_add(state.pos, w_pos, f),
        neg=independent_gaussian_add(state.neg, w_neg, f))


def independent_nb_predict_real(state: IndependentNB, x):
    """Posterior difference (predict_real_impl,
    independent_naive_bayes.hpp:105-113)."""
    f = _sub(state, x)
    total = state.pos_w + state.neg_w
    return (state.pos_w / total * independent_gaussian_prob(state.pos, f)
            - state.neg_w / total * independent_gaussian_prob(state.neg, f))


def independent_nb_predict(state: IndependentNB, x):
    return torch.where(independent_nb_predict_real(state, x) > 0, 1,
                       -1).to(torch.int32)
