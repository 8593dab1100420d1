"""Training: the flow network's training loop, the JAX package's
``train/`` in PyTorch. Scenes are made on the device
(``data_synth.py``); on CUDA tensors the correlation's forward and
backward are the hand-written kernels; ``make_sharded_train_step``
spreads the step over a ``torch.distributed`` (data, model) mesh."""

from .flow_trainer import (
    FlowOptimizer,
    FlowTrainState,
    create_train_state,
    flow_loss,
    make_chunked_train_step,
    make_sharded_train_step,
    synthetic_flow_batch,
    train_step,
)

__all__ = [
    "FlowOptimizer",
    "FlowTrainState",
    "create_train_state",
    "flow_loss",
    "make_chunked_train_step",
    "make_sharded_train_step",
    "synthetic_flow_batch",
    "train_step",
]
