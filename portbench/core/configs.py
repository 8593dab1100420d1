"""A configuration file's pipeline as a ``PipelineConfig`` of either
package: the port's (``moving_object_detector_tpu_torch.config``) or the
reference's copy (``portbench/reference/config.py``), which have the same
fields."""

from __future__ import annotations

import dataclasses

GROUPS = ("sgm", "clusterer", "tracker", "scene_flow", "egomotion",
          "flownet")
TOP = ("height", "width", "color", "flow_input_scale", "sgm_input_scale")


def values(d: dict) -> dict:
    """A file's group with its lists as the tuples the dataclasses hold."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def pipeline_config(config_module, cfg: dict, **flownet_overrides):
    """The ``PipelineConfig`` of ``config_module`` that the file ``cfg``
    states: the defaults with every value the file gives."""
    base = config_module.PipelineConfig()
    groups = {}
    for name in GROUPS:
        vals = values(cfg.get(name, {}))
        if name == "flownet":
            vals.update(flownet_overrides)
        groups[name] = dataclasses.replace(getattr(base, name), **vals)
    return dataclasses.replace(base, **{k: cfg[k] for k in TOP if k in cfg},
                               **groups)


def flownet_fields(cfg: dict) -> dict:
    """The architecture the file states, to hold the loaded weights to."""
    return values({k: v for k, v in cfg["flownet"].items()
                   if k not in ("dtype", "corr_backend")})
