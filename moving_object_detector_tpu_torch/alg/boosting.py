"""Online AdaBoost (the JAX package's ``alg/boosting.py``,
kkl/ml/online_boosting.hpp).

Grabner / Bischof online boosting ("On-line Boosting and Vision"):
``n_selectors`` selectors, each holding ``n_weak`` weak classifiers; a
training sample flows through the selectors in order, its importance
weight (lambda) rescaled by each selector's best error rate
(online_boosting.hpp:101-151,266-279).

All weak classifiers live in one stacked :class:`~.classifiers.
IndependentNB` with leading axes (n_selectors, n_weak): a selector's
weak learners update together as batched tensor ops, while the selector
chain is a loop carrying lambda, the one sequential dependency of the
algorithm. Nothing waits for the device.

Weak learners are naive-Bayes stumps over random static feature subsets
(the role of the reference's WeakClassifierGenerator). Deliberate
fixed-shape deviations, the JAX package's:

* no weak-classifier replacement (generate / replace,
  online_boosting.hpp:88-96,268-277): the recursive estimators inside
  each stump adapt online; the stump POOL is fixed, its PARAMETERS are
  not.
* a "bad selector" (best error > 0.5, online_boosting.hpp:138-142) gets
  voting weight 0 and passes lambda through unchanged instead of
  replace + break.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from .classifiers import (
    IndependentNB,
    independent_nb_init,
    independent_nb_predict_real,
    independent_nb_update,
)
from .gaussian import _f32


class OnlineBoosting(NamedTuple):
    weak: IndependentNB         # stacked, leading axes (S, M)
    lambda_corr: torch.Tensor   # (S, M)
    lambda_wrong: torch.Tensor  # (S, M)


def _map(fn, tree):
    """``fn`` on every tensor of a tree of NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(_map(fn, x) for x in tree))


def _stack(items):
    """One tree of NamedTuples from a list of them, tensors stacked on a
    new leading axis."""
    if isinstance(items[0], torch.Tensor):
        return torch.stack(items)
    return type(items[0])(*(_stack(list(f)) for f in zip(*items)))


def online_boosting_init(n_selectors: int, n_weak: int, dim: int,
                         subset_size: int | None = None, seed: int = 0,
                         device=None) -> OnlineBoosting:
    """Build the ensemble: every stump sees a random feature subset of
    ``subset_size`` (default ceil(sqrt(dim))). The subsets are drawn with
    numpy from ``seed``, as the JAX package draws them, so both packages
    build the same ensemble."""
    dev = resolve_device(device)
    if subset_size is None:
        subset_size = max(1, int(np.ceil(np.sqrt(dim))))
    rng = np.random.default_rng(seed)
    subs = [np.sort(rng.choice(dim, size=subset_size, replace=False))
            for _ in range(n_selectors * n_weak)]
    weak = _stack([independent_nb_init(dim, sub_indices=s, device=dev)
                   for s in subs])
    weak = _map(lambda x: x.reshape((n_selectors, n_weak) + x.shape[1:]),
                weak)
    # errors start at 0.5 via the (1, 1) correct / wrong accumulators
    # (WeakClassifierSelector::push, online_boosting.hpp:81-86).
    ones = torch.ones((n_selectors, n_weak), device=dev)
    return OnlineBoosting(weak=weak, lambda_corr=ones, lambda_wrong=ones)


def online_boosting_update(state: OnlineBoosting, label,
                           x) -> OnlineBoosting:
    """One training sample through the selector chain
    (OnlineBoosting::update, online_boosting.hpp:242-279 +
    WeakClassifierSelector::update, :101-151)."""
    label, x = _f32(state.lambda_corr, label, x)[1:]
    sign = torch.where(label > 0, 1.0, -1.0)
    lam = torch.abs(label)
    weaks, corrs, wrongs = [], [], []
    for s in range(state.lambda_corr.shape[0]):
        signed = sign * torch.abs(label) * lam  # label * lambda
        w = torch.abs(signed)
        weak = independent_nb_update(_map(lambda t: t[s], state.weak),
                                     signed, x)
        pred = independent_nb_predict_real(weak, x)
        success = torch.where(pred > 0, 1.0, -1.0) == sign
        zero = torch.zeros_like(w)
        corr = state.lambda_corr[s] + torch.where(success, w, zero)
        wrong = state.lambda_wrong[s] + torch.where(success, zero, w)
        errors = wrong / (corr + wrong)
        best = torch.argmin(errors)
        best_err = errors[best]
        bad = (best_err > 0.5) | (best_err <= 0.0)
        lam = torch.where(bad, lam, torch.where(
            success[best], lam / (2.0 * (1.0 - best_err)),
            lam / (2.0 * best_err)))
        weaks.append(weak)
        corrs.append(corr)
        wrongs.append(wrong)
    return OnlineBoosting(weak=_stack(weaks), lambda_corr=torch.stack(corrs),
                          lambda_wrong=torch.stack(wrongs))


def _selector_votes(state: OnlineBoosting, x):
    """(S,) per-selector vote = voting_weight * best stump's real
    prediction (WeakClassifierSelector::predict,
    online_boosting.hpp:153-160)."""
    pred = independent_nb_predict_real(state.weak, x)  # (S, M)
    errors = state.lambda_wrong / (state.lambda_corr + state.lambda_wrong)
    best = torch.argmin(errors, dim=1, keepdim=True)  # (S, 1)
    best_err = torch.gather(errors, 1, best)[:, 0]
    voting_w = torch.where(
        (best_err > 0.5) | (best_err <= 0.0), 0.0,
        0.5 * torch.log((1.0 - best_err) / best_err))
    return voting_w * torch.gather(pred, 1, best)[:, 0]


def online_boosting_predict_real(state: OnlineBoosting, x):
    """Sigmoid-squashed ensemble confidence in (-1, 1) (predictReal,
    online_boosting.hpp:293-305)."""
    accum = torch.sum(_selector_votes(state, x))
    n_sel = state.lambda_corr.shape[0]
    upper = 0.5 * np.log((1.0 - 0.05) / 0.05) * n_sel
    gain = 3.0 / upper
    return 2.0 / (1.0 + torch.exp(-gain * accum)) - 1.0


def online_boosting_predict(state: OnlineBoosting, x):
    """+1 / -1 (predict, online_boosting.hpp:312-314)."""
    return torch.where(online_boosting_predict_real(state, x) > 0, 1,
                       -1).to(torch.int32)
