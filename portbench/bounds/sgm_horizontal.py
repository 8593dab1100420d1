"""Bytes and operations of one launch of the horizontal SGM DP
(``csrc/sgm_v2.cu`` ``hdp_kernel``) from its call shapes.

Frozen from ``chip_smoke.py`` ``check_sgm_kernels`` at fc97bde: the two
census images read once (4 bytes a pixel each) and the two int8 delta
volumes written once (D bytes a pixel each); 12 scalar operations a DP
update (cost: xor, popc, select; recurrence: 4 min, 2 add, 1 sub; a share
of the warp min and the neighbour shuffles), two directions over every
pixel and disparity.
"""

import re

NAME = "sgm_horizontal"
TARGET = "moving_object_detector_tpu_torch.ops.sgm_cuda:horizontal_deltas"
DEVICE_NAME = re.compile(r"hdp_kernel")
D = 128
OPS_PER_DP_UPDATE = 12


def bytes_ops(cl, cr, *args, **kwargs):
    n = cl.shape[0] * cl.shape[1]
    return 2 * n * 4 + 2 * n * D, 2 * n * D * OPS_PER_DP_UPDATE
