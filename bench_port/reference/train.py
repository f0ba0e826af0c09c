"""The plain reference of the fine-tune step: symmetric InfoNCE over the
reference CLIP's l2-normalised embeddings with a learned temperature
(CLIP's loss), its gradient by autograd, and AdamW with decoupled weight
decay (Loshchilov and Hutter; PyTorch's ``AdamW`` update), all in f32 on
every parameter, each block recomputed in the backward to bound memory.
The photos are decoded and resized by PIL (``clip.preprocess``), the
captions tokenized by the project's hash tokenizer (``clip.hash_tokens``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_port.reference.clip import Clip, f32_exact, hash_tokens, preprocess


def leaves(tensors: dict) -> dict:
    """The published model's leaves: a fused qkv projection's weight and
    bias are the q, k and v projections' (HF CLIP keeps them apart; a key's
    bias has no gradient under softmax, a query's has)."""
    out = {}
    for k, t in tensors.items():
        if k.endswith(("qkv.weight", "qkv.bias")):
            out.update({f"{k}[{part}]": chunk for part, chunk in zip("qkv", t.chunk(3, dim=0))})
        else:
            out[k] = t
    return out


def leaf_norms(tensors: dict, scale: float = 1.0) -> dict:
    """Each leaf's l2 norm (times ``scale``), read back in one transfer."""
    split = leaves(tensors)
    norms = torch.stack([torch.linalg.vector_norm(t.float()) for t in split.values()]) * scale
    return dict(zip(split, norms.tolist()))


BETA1, BETA2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01


def loss_fn(model: Clip, params: dict, ids, pixels):
    img = F.normalize(model.encode_image(pixels, remat=True), dim=-1)
    txt = F.normalize(model.encode_text(ids, remat=True), dim=-1)
    logits = torch.exp(params["logit_scale"]) * img @ txt.t()
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels))


def steps(m: dict, state: dict, pairs: list, n: int, lr: float, device, lowp=None, first_grads=None) -> dict:
    """``n`` steps on the batch of ``pairs`` (all of them, in order) ->
    {losses, grad_norms (each leaf's, step 1), step_norms (each leaf's change
    over the n steps)}; ``first_grads``, when given, receives step 1's
    gradient of every parameter (on the host)."""
    tc = m["text"]
    ids = hash_tokens([c for _, c in pairs], tc["vocab_size"], tc["context_length"], tc["eos_token_id"]).to(device)
    pixels = torch.stack([preprocess(p, m["vision"]["image_size"]) for p, _ in pairs]).to(device)
    params = {k: v.detach().float().clone().requires_grad_(True) for k, v in state.items()}
    p0 = {k: v.detach().clone() for k, v in params.items()}
    exp_avg = {k: torch.zeros_like(v) for k, v in params.items()}
    exp_sq = {k: torch.zeros_like(v) for k, v in params.items()}
    model = Clip(m, params, lowp=lowp)
    losses, grad_norms = [], {}
    with f32_exact():
        for t in range(1, n + 1):
            loss = loss_fn(model, params, ids, pixels)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                if t == 1:
                    grad_norms = leaf_norms(dict(zip(params, grads)))
                    if first_grads is not None:
                        first_grads.update({k: g.cpu() for k, g in zip(params, grads)})
                bc1, bc2 = 1 - BETA1**t, 1 - BETA2**t
                for (k, p), g in zip(params.items(), grads):
                    p.mul_(1 - lr * WEIGHT_DECAY)
                    exp_avg[k].lerp_(g, 1 - BETA1)
                    exp_sq[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                    denom = (exp_sq[k].sqrt() / bc2**0.5).add_(EPS)
                    p.addcdiv_(exp_avg[k], denom, value=-lr / bc1)
            del grads
    step_norms = leaf_norms({k: params[k].detach() - p0[k] for k in params})
    return {"losses": losses, "grad_norms": grad_norms, "step_norms": step_norms}
