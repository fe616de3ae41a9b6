"""Percent of the traced window in which the card is idle while the host's
innermost program span is one of the training step's: ``train_upload``,
``train_forward``, ``train_backward``, ``train_optimizer`` or
``train_metrics``."""

from benchmark.harness.program import idle_in

STEP = ("train_upload", "train_forward", "train_backward",
        "train_optimizer", "train_metrics")


def read(trace):
    return idle_in(trace, STEP)
