"""Bytes and operations of one launch of ego-motion's RANSAC
(``csrc/gauss_newton.cu`` ``ransac_gn_kernel``) from its call shapes.

Frozen from ``chip_smoke.py`` ``ransac_bytes_ops`` and its constants at
fc97bde: each input once (points 12 bytes, tracks 8, validity 1 a
feature; the hypotheses' indices 8 a draw), the outputs once; the
hypotheses' solves, their scores, the ranking, each candidate's two
refinements and three passes of residuals.
"""

import re

NAME = "ransac_gn"
TARGET = "moving_object_detector_tpu_torch.ops.gauss_newton_cuda:ransac_solve"
DEVICE_NAME = re.compile(r"ransac_gn_kernel")
# Per point and iteration: transform 18, projection and residual 12,
# Jacobian 76, J^T W J and J^T W r 108, selects 10; per problem and
# iteration the 6 x 6 Cholesky and substitutions, the exponential and
# the 4 x 4 product, about 400. Per point and hypothesis or candidate:
# transform 18, projection 6, residual and its norm 6, the MSAC term and
# the inlier test 4; per pair of hypotheses ranked, 4.
OPS_PER_GN_POINT = 224
OPS_PER_GN_SOLVE = 400
OPS_PER_GN_RESIDUAL = 34
OPS_PER_RANK = 4


def bytes_ops(pts3d, tracked, feat_valid, cam, sample_idx, cfg, *args,
              **kwargs):
    n = pts3d.shape[0]
    h, s = sample_idx.shape
    k = min(max(1, min(cfg.refine_candidates, cfg.ransac_hypotheses)), h)
    nbytes = 12 * n + 8 * n + n + 8 * h * s + 16 + 64 + 1 + 4
    ops = (cfg.gn_iters_hypothesis * (OPS_PER_GN_POINT * h * s
                                      + OPS_PER_GN_SOLVE * h)
           + OPS_PER_GN_RESIDUAL * h * n + OPS_PER_RANK * h * h
           + k * (2 * cfg.gn_iters_refine * (OPS_PER_GN_POINT * n
                                             + OPS_PER_GN_SOLVE)
                  + 3 * OPS_PER_GN_RESIDUAL * n))
    return nbytes, ops
