"""Training-state checkpoints: resumable fine-tuning.

The model checkpoint (safetensors, ``models/convert.py``) carries the
parameters only, which is what serving needs. Resuming a run exactly also
needs the AdamW moments and the step; the reference keeps them with orbax,
the port in its own torch format: one ``train_state.pt`` file (model state,
optimizer state, step) in the directory. A save writes a new directory beside
the old one and swaps it in with ``os.replace``, so a directory is never
half-written (orbax's atomic swap).
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from typing import Optional

import torch

from image_search_tpu_torch.train.contrastive import TrainState

log = logging.getLogger(__name__)

STATE_FILE = "train_state.pt"


def save_train_state(directory: str, state: TrainState) -> None:
    path = os.path.abspath(directory)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp-", dir=parent)
    try:
        torch.save(
            {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(), "step": state.step},
            os.path.join(tmp, STATE_FILE),
        )
        if os.path.exists(path):
            old = tmp + ".old"
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    log.info("saved train state (step %d) to %s", state.step, path)


def load_train_state(directory: str, template: TrainState) -> Optional[TrainState]:
    """Restore a state saved by :func:`save_train_state` into ``template``
    (built with the same ``init_fn`` as a fresh run); None when absent."""
    path = os.path.join(os.path.abspath(directory), STATE_FILE)
    if not os.path.exists(path):
        return None
    device = next(template.model.parameters()).device
    saved = torch.load(path, map_location=device, weights_only=True)
    template.model.load_state_dict(saved["model"])
    template.optimizer.load_state_dict(saved["optimizer"])
    template.step = int(saved["step"])
    log.info("restored train state (step %d) from %s", template.step, path)
    return template
