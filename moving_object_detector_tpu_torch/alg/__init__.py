"""Reusable algorithm library (the JAX package's ``alg``, the reference's
kkl toolkit): the general-purpose pieces a user of the reference could
reach for, though the detection pipeline does not wire them in. Its
pipeline-critical pieces live elsewhere (``tracker.py``: the batched
Kalman filter and nearest-neighbour association; ``ops/assignment.py``:
the Hungarian solver).

* ``alg.gaussian``: kkl/math/gaussian.hpp: densities, Mahalanobis, KL,
  fitting, incremental / recursive estimators, mixture models.
* ``alg.classifiers``: kkl/ml/{flann_knn_classifier,
  incremental_naive_bayes, independent_naive_bayes}.hpp: a
  fixed-capacity brute-force kNN and online naive-Bayes classifiers.
* ``alg.boosting``: kkl/ml/online_boosting.hpp: online AdaBoost over
  naive-Bayes stumps.
* ``alg.icf``: kkl/cvk/*: integral-channel features (HSV / LUV /
  gradient-histogram channels, integral images, box filters) and the
  cvutils palette / rect helpers.

Plain PyTorch functions on tensors, no kernel: each runs on the device
of its tensors; the state constructors take a ``device`` (``cuda``
unless the caller passes ``device="cpu"``).
"""

from . import boosting, classifiers, gaussian, icf  # noqa: F401
