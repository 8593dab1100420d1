"""Trees of tensors: the port's messages (``types.py``) and the tuples,
lists and dicts of them that stages take and return, walked in one order:
a dataclass's fields in declaration order, a sequence's items, a dict's
values."""

from __future__ import annotations

import dataclasses

import torch


def map_tensors(node, fn):
    """``node`` with ``fn`` applied to every tensor in it; dataclasses,
    tuples, lists and dicts are walked, other leaves kept."""
    if isinstance(node, torch.Tensor):
        return fn(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return type(node)(**{f.name: map_tensors(getattr(node, f.name), fn)
                             for f in dataclasses.fields(node)})
    if isinstance(node, (tuple, list)):
        return type(node)(map_tensors(x, fn) for x in node)
    if isinstance(node, dict):
        return {k: map_tensors(v, fn) for k, v in node.items()}
    return node


def leaves(node) -> list:
    """The tensors of ``node``, in the order ``map_tensors`` visits them."""
    if isinstance(node, torch.Tensor):
        return [node]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        node = [getattr(node, f.name) for f in dataclasses.fields(node)]
    elif isinstance(node, dict):
        node = list(node.values())
    elif not isinstance(node, (tuple, list)):
        return []
    return [x for v in node
            for x in ((v,) if isinstance(v, torch.Tensor) else leaves(v))]
