"""Module modes: batch statistics in a training step, running statistics
in evaluation.

The port draws its dropout explicitly (``draw``), so a module's mode
changes nothing in the text models and the JAX package's OmniGlot stack.
It matters to the published OmniGlot model's batch norm
(models/enc_resnet_bn.py, models/dec_pixelcnn_bn.py): a training step
(``make_train_epoch``'s static step, aggressive sub-iterations included)
normalizes with the batch's statistics and updates the running ones; the
evaluators (ELBO, MI, AU, IW-NLL), generation and reconstruction use the
running statistics and update nothing.
"""
from __future__ import annotations

from contextlib import contextmanager

from torch import nn


@contextmanager
def module_mode(module: nn.Module, training: bool):
    """``module`` and its submodules in training (``training``) or
    evaluation mode inside, each submodule's own mode restored after."""
    before = [(m, m.training) for m in module.modules()]
    module.train(training)
    try:
        yield module
    finally:
        for m, was in before:
            m.training = was
