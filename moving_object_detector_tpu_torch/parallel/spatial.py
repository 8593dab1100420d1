"""Spatial (row-stripe) sharding of the perception stages over a mesh axis.

Scales ONE camera across several ranks, the complement of the stream
data parallelism in ``parallel/streams.py``. The image's row axis is
split over the mesh's "model" axis: each rank computes its stripe
extended by a halo of its neighbours' rows, crops the halo off, and the
full-height field is reassembled with one all-gather over the axis's
process group.

Exactness contract (the JAX package's):

* Optical flow (PWC-Net): convolutional with a finite receptive field, so
  a halo of one pyramid stride makes interior pixels match the unsharded
  result up to boundary bleed at the coarsest levels.
* SGM: the horizontal DP paths, the WTA and the LR check are row-local
  (exact under row sharding). The vertical DP paths are global
  recurrences; stripe processing warms them up over the halo rows, the
  "striped SGM" scheme of embedded SGM implementations, so a 32-row halo
  bounds the seam error to a small fraction of pixels.

Boundary stripes fill their missing outer halo by edge replication; the
filled rows are census / DP warm-up context only and are always cropped.

The striped SGM runs at full resolution whatever ``sgm_input_scale``
says, and its disparity image carries no scale factor: the JAX package
does the same (``detect_step_streams_spatial``), and the port follows its
reference.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import SGMConfig
from ..ops.sgm import disparity_with_metadata, sgm_disparity_raw
from ..pipeline import _flow_forward
from ..types import DisparityImage, StereoModel
from .streams import _step_streams, stack_states

# torch 2.13 has all_gather_single and deprecates all_gather_into_tensor;
# older releases (2.11 among them) have only the latter.
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _transport(group, tensors, move):
    """``move(*tensors)`` -> tuple of received tensors: the collective that
    carries halo rows or stripes between the ranks of ``group``, and the
    only place the parallel code moves data off the card.

    Under NCCL the device tensors go as they are. Gloo has no CUDA
    point-to-point or all-gather, so under gloo CUDA tensors are staged
    through host memory: copied to the CPU, moved, and the received
    buffers copied back to the device. The computation stays on the
    card either way."""
    device = tensors[0].device
    if device.type == "cuda" and dist.get_backend(group) == "gloo":
        received = move(*(t.cpu() for t in tensors))
        return tuple(r.to(device) for r in received)
    return move(*tensors)


def _neighbor_rows(x: torch.Tensor, halo: int, group, n: int):
    """(top_halo, bottom_halo) rows for the local stripe: the previous
    rank's last rows and the next rank's first rows, exchanged with one
    ``batch_isend_irecv`` over ``group``; edge-replicated where there is
    no neighbour (first / last stripe). The row axis is -2."""
    idx = dist.get_group_rank(group, dist.get_rank())
    top_rows = x[..., :halo, :].contiguous()
    bot_rows = x[..., -halo:, :].contiguous()

    def move(top, bot):
        from_prev, from_next = torch.empty_like(bot), torch.empty_like(top)
        ops = []
        # My top rows become the previous rank's bottom halo, my bottom
        # rows the next rank's top halo.
        if idx > 0:
            peer = dist.get_global_rank(group, idx - 1)
            ops += [dist.P2POp(dist.isend, top, peer, group),
                    dist.P2POp(dist.irecv, from_prev, peer, group)]
        if idx < n - 1:
            peer = dist.get_global_rank(group, idx + 1)
            ops += [dist.P2POp(dist.isend, bot, peer, group),
                    dist.P2POp(dist.irecv, from_next, peer, group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return from_prev, from_next

    from_prev, from_next = _transport(group, (top_rows, bot_rows), move)
    top = x[..., :1, :].expand_as(top_rows) if idx == 0 else from_prev
    bot = x[..., -1:, :].expand_as(bot_rows) if idx == n - 1 else from_next
    return top, bot


def _with_halo(x: torch.Tensor, halo: int, group, n: int) -> torch.Tensor:
    if halo == 0:  # no-halo operating point (seam-error baselines)
        return x
    top, bot = _neighbor_rows(x, halo, group, n)
    return torch.cat([top, x, bot], dim=-2)


def _gather_rows(x: torch.Tensor, group, n: int, axis: int) -> torch.Tensor:
    """The full-height field from every rank's stripe of ``x`` along
    ``axis``, in rank order: one all-gather over ``group``."""
    local = x.movedim(axis, 0).contiguous()

    def move(t):
        out = t.new_empty((n * t.shape[0],) + t.shape[1:])
        _all_gather(out, t, group=group)
        return (out,)

    (full,) = _transport(group, (local,), move)
    return full.movedim(0, axis)


def _axis(mesh, axis: str):
    """(size, this rank's index, process group) of a mesh axis."""
    return (mesh.size(mesh.mesh_dim_names.index(axis)),
            mesh.get_local_rank(axis), mesh.get_group(axis))


def compute_disparity_spatial(left: torch.Tensor, right: torch.Tensor,
                              stereo: StereoModel, cfg: SGMConfig, mesh,
                              axis: str = "model",
                              halo: int = 32) -> DisparityImage:
    """SGM with the row axis split over ``mesh``'s ``axis``: every rank of
    the axis passes the same (H, W) pair, computes its stripe plus an
    exchanged halo and returns the full disparity. H must divide by the
    axis size; the halo must not exceed the stripe height."""
    n, idx, group = _axis(mesh, axis)
    h = left.shape[0]
    stripe = h // n
    assert h % n == 0, (h, n)
    assert 0 <= halo <= stripe, f"halo {halo} outside [0, {stripe}]"
    rows = slice(idx * stripe, (idx + 1) * stripe)
    le = _with_halo(left[rows], halo, group, n)
    re_ = _with_halo(right[rows], halo, group, n)
    disp = sgm_disparity_raw(le, re_, cfg)[halo:halo + stripe]
    return disparity_with_metadata(_gather_rows(disp, group, n, 0), stereo,
                                   cfg)


def flow_forward_spatial(flow_model, prev_img: torch.Tensor,
                         now_img: torch.Tensor, mesh, axis: str = "model",
                         halo: int = 64, input_scale: int = 1):
    """PWC-Net forward with the row axis split over ``axis``: (H, W)
    images on every rank of the axis -> the full (H, W, 2) flow. Each
    stripe runs the whole pyramid on its halo-extended rows (the net pads
    to the pyramid stride), then crops. ``input_scale`` is the pipeline's
    ``flow_input_scale``, so the split flow matches the unsplit serving
    point."""
    n, idx, group = _axis(mesh, axis)
    h = now_img.shape[0]
    stripe = h // n
    assert h % n == 0, (h, n)
    assert 0 <= halo <= stripe, f"halo {halo} outside [0, {stripe}]"
    rows = slice(idx * stripe, (idx + 1) * stripe)
    pe = _with_halo(prev_img[rows], halo, group, n)
    qe = _with_halo(now_img[rows], halo, group, n)
    flow = _flow_forward(flow_model, pe, qe, input_scale=input_scale)
    return _gather_rows(flow[halo:halo + stripe], group, n, 0)


def detect_step_streams_spatial(flow_model, states, lefts, rights, ts,
                                stereo: StereoModel, config, mesh,
                                row_axis: str = "model",
                                sgm_halo: int = 32, flow_halo: int = 64):
    """Streams x spatial over a (data, model) mesh: this rank's streams
    (its "data" shard, e.g. ``shard_streams(...).to_local()``: ``lefts``
    / ``rights`` (n, H, W), stacked ``states``, ``ts`` (n,), the same on
    every rank of its "model" group) with each stream's SGM and flow net
    split in row stripes over ``row_axis``.

    Each rank slices its stripe plus halo from the replicated images
    (edge replication at the image border, as the single-stream kernels
    pad), runs SGM and the flow net on it, and one all-gather per product
    over the row group reassembles the full-height fields. The rest of
    the frame program (ego-motion, scene flow, clusterer, tracker) then
    runs on every rank of the group on the configured backends, with the
    gathered fields as overrides. Returns (states', outputs) of this
    rank's streams, stacked."""
    n_rows, mp, group = _axis(mesh, row_axis)
    h = lefts.shape[1]
    assert h % n_rows == 0, (h, n_rows)
    stripe = h // n_rows
    assert max(sgm_halo, flow_halo) <= h, (sgm_halo, flow_halo, h)

    def stripe_rows(x, halo):
        """Rows [mp * stripe - halo, mp * stripe + stripe + halo) of the
        edge-replicated image stack."""
        pad = (x.shape[0], halo) + x.shape[2:]
        xp = torch.cat([x[:, :1].expand(pad), x, x[:, -1:].expand(pad)], 1)
        return xp[:, mp * stripe:mp * stripe + stripe + 2 * halo]

    lefts, rights = lefts.float(), rights.float()
    disp = torch.stack([
        sgm_disparity_raw(a, b, config.sgm) for a, b in
        zip(stripe_rows(lefts, sgm_halo), stripe_rows(rights, sgm_halo))
    ])[:, sgm_halo:sgm_halo + stripe]
    flow = torch.stack([
        _flow_forward(flow_model, a, b, input_scale=config.flow_input_scale,
                      corr_backend=config.flownet.corr_backend)
        for a, b in zip(stripe_rows(states.prev_left, flow_halo),
                        stripe_rows(lefts, flow_halo))
    ])[:, flow_halo:flow_halo + stripe]
    disp = _gather_rows(disp, group, n_rows, 1)
    flow = _gather_rows(flow, group, n_rows, 1)
    dimgs = stack_states([disparity_with_metadata(d, stereo, config.sgm)
                          for d in disp])
    return _step_streams(flow_model, states, lefts, rights, ts, stereo,
                         config, flow, dimgs)
