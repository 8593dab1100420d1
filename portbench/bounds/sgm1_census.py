"""Bytes and operations of one launch of the census transform of both
views (``csrc/sgm_v1.cu`` ``census_kernel``, ``census_pair``) from its
call shapes.

Frozen from ``chip_smoke.py`` ``check_sgm_v1_kernels`` at fc97bde: two f32
images read and two int32 census images written once; a compare and an
or for each of the 24 neighbours of every pixel of both views.
"""

import re

NAME = "sgm1_census"
TARGET = "moving_object_detector_tpu_torch.ops.sgm_v1_cuda:census_pair"
DEVICE_NAME = re.compile(r"census_kernel")
OPS_PER_CENSUS_NEIGHBOUR = 2


def bytes_ops(left, right, *args, **kwargs):
    n = left.shape[0] * left.shape[1]
    return 2 * 2 * n * 4, 2 * n * 24 * OPS_PER_CENSUS_NEIGHBOUR
