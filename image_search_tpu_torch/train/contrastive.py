"""Contrastive (CLIP-style) fine-tuning on one device.

Port of ``image_search_tpu/train/contrastive.py``: symmetric InfoNCE over
image/text pairs with a learned temperature, and a train step that takes one
AdamW update of every parameter (``logit_scale`` included, as optax does).
Parameters are f32 master weights; the towers compute in ``compute_dtype``
(bf16 on the card) with each weight cast at its use, as the reference's
step does. Every attention core's backward runs kernel B5 on the card.

Multi-device training (a mesh, tensor parallelism, FSDP) is not ported yet
and raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F

from image_search_tpu_torch import check_precision
from image_search_tpu_torch.models import clip as model_lib


@dataclasses.dataclass
class TrainState:
    """The reference's ``TrainState(params, opt_state, step)``: the model
    holds the parameters, the optimizer its moments."""

    model: model_lib.CLIP
    optimizer: torch.optim.Optimizer
    step: int = 0


def clip_loss(img_emb: torch.Tensor, txt_emb: torch.Tensor, scale: torch.Tensor):
    """Symmetric InfoNCE over l2-normalized embeddings, in f32.

    Returns (loss, metrics). Labels are the diagonal: pair i matches pair i.
    """
    logits = scale * torch.einsum("bp,cp->bc", img_emb.float(), txt_emb.float())
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
    acc = (torch.argmax(logits, dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "img_to_txt_acc": acc, "logit_scale": scale}


def adamw(learning_rate: float, weight_decay: float = 0.01):
    """``optax.adamw(learning_rate, weight_decay=...)``: params -> optimizer."""
    return functools.partial(
        torch.optim.AdamW, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
    )


def make_train_step(
    cfg,
    optimizer,
    compute_dtype=torch.float32,
    remat: bool = False,
    device="cuda",
    *,
    remat_policy: str = "",
    mesh: Any = None,
    fsdp: bool = False,
):
    """Returns (init_fn(model) -> state, step_fn(state, ids, pixels) ->
    (state, metrics)).

    ``optimizer`` maps parameters to a ``torch.optim.Optimizer`` (for
    example :func:`adamw`). ``remat=True`` recomputes block activations in
    the backward pass under ``remat_policy`` (``models.clip.REMAT_POLICIES``;
    "" is full remat). The step updates the state in place and returns it.
    """
    if mesh is not None or fsdp:
        raise NotImplementedError("multi-device training (mesh, fsdp) is not ported yet (ROADMAP A.12)")
    if cfg.arch == "siglip":
        raise NotImplementedError("SigLIP training is not ported yet (ROADMAP A.10)")
    if remat_policy not in model_lib.REMAT_POLICIES:
        raise ValueError(f"remat policy {remat_policy!r}; known: {sorted(model_lib.REMAT_POLICIES)}")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
        check_precision()  # the f32 preprocess and f32 matmuls stay out of TF32

    def init_fn(model: model_lib.CLIP) -> TrainState:
        model = model.to(device).requires_grad_(True).train()
        return TrainState(model, optimizer(model.parameters()), 0)

    def step_fn(state: TrainState, input_ids, pixels):
        ids = torch.as_tensor(input_ids).to(device=device, dtype=torch.long)
        px = torch.as_tensor(pixels).to(device)
        state.optimizer.zero_grad(set_to_none=True)
        img, txt, scale = model_lib.forward(state.model, ids, px, compute_dtype, remat, remat_policy)
        loss, metrics = clip_loss(img, txt, scale)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return init_fn, step_fn
