"""Checkpoints of the port's trainer, and a loader for every weight format
the port can read.

Port of ``tandem_tpu/train/checkpoint.py`` (the reference's PL
ModelCheckpoint + load_ckpt, cva_mvsnet/train.py:118,
models/utils/load_ckpt.py:36-48):

- ``save_checkpoint`` writes ``<ckpt_dir>/step_<N:08d>/checkpoint.pt`` with
  ``torch.save``: the model's state_dict (parameters and BatchNorm
  statistics), the optimizer's and the LR scheduler's state, and the step;
- ``load_any`` reads such a directory, the JAX package's pickled variables
  (``model_variables.pkl``, through ``models/convert.flax_to_state_dict``)
  and a reference torch checkpoint or state_dict (a PyTorch-Lightning
  ``.ckpt`` with ``state_dict``, keys with or without the ``model.`` /
  ``cva_mvsnet.`` prefix). The JAX package's own orbax checkpoints need
  orbax, which the port does not use: they raise.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from ..models.convert import flax_to_state_dict, load_variables

CHECKPOINT_FILE = "checkpoint.pt"
FORMAT = "tandem_tpu_torch"


def save_checkpoint(ckpt_dir: str, state, step: Optional[int] = None) -> str:
    step = state.step if step is None else step
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}"))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
    torch.save({"format": FORMAT, "step": state.step,
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict()}, tmp)
    os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
    return path


def _read(path: str) -> dict:
    payload = torch.load(os.path.join(path, CHECKPOINT_FILE),
                         map_location="cpu", weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path}: not a tandem_tpu_torch checkpoint")
    return payload


def load_checkpoint(path: str, state):
    """Restore model, optimizer, scheduler and step into ``state``."""
    payload = _read(path)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.scheduler.load_state_dict(payload["scheduler"])
    state.step = int(payload["step"])
    return state


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def _reference_state_dict(sd: Dict[str, torch.Tensor]):
    out = {}
    for k, v in sd.items():
        for prefix in ("cva_mvsnet.", "model."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k] = v
    return out


def load_any(path: str, state=None, view_aggregation: bool = True,
             architecture: str = "cva_mvsnet"):
    """Read weights of any format the port knows.

    :return: the restored ``state`` for a port checkpoint directory when a
        state is given, else the model's state_dict
    """
    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, CHECKPOINT_FILE)):
            raise NotImplementedError(
                f"{path}: a directory without {CHECKPOINT_FILE} (an orbax "
                "checkpoint of the JAX package?) cannot be read without "
                "orbax; export its variables to model_variables.pkl with "
                "the JAX package (ROADMAP Queue 1 item 6)")
        if state is not None:
            return load_checkpoint(path, state)
        return _read(path)["model"]
    if path.endswith(".pkl"):
        return flax_to_state_dict(load_variables(path), view_aggregation,
                                  architecture)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") == FORMAT:
        return payload["model"]
    return _reference_state_dict(payload.get("state_dict", payload))
