"""LM batch helpers shared by the LM training paths (counterpart of the JAX
``parallel/seq_parallel.py``; its ring and sequence-parallel steps are not
ported yet).

- :func:`next_token_targets`: host-side shifted targets; the final position
  is padded and masked out of the loss.
- :func:`create_lm_train_state`: a model paired with the optimizer's state.
"""

from __future__ import annotations

import numpy as np
import torch.nn as nn

from distributed_ml_pytorch_tpu_torch.training.trainer import SGD, TrainState


def next_token_targets(tokens: np.ndarray, pad_id: int = 0) -> np.ndarray:
    """Position i predicts token i+1; the final position gets ``pad_id`` and
    is masked by position in the loss."""
    return np.concatenate(
        [tokens[:, 1:], np.full((tokens.shape[0], 1), pad_id, tokens.dtype)], axis=1
    )


def create_lm_train_state(model: nn.Module, tx: SGD) -> TrainState:
    """``model`` with ``tx``'s fresh state. The JAX function initialises the
    parameters from its rng here; a port model holds its parameters from
    construction, drawn from the ``seed`` it was built with."""
    return TrainState(model, tx.init(list(model.parameters())))
