"""Multi-head attention core: kernel B1 and its plain PyTorch version.

``fused_attention`` is the port of ``image_search_tpu/ops/attention.py::
fused_attention_grouped`` (Pallas ``_attn_kernel_grouped``), which runs every
attention layer of both CLIP towers except the CLS/EOS-only last one. On a
CUDA tensor it launches ``csrc/attention.cu``; on a CPU tensor it runs
:func:`attention_reference`. There is no other route: a CUDA tensor the kernel
cannot take raises.

Both follow the grouped kernel's rounding points: f32 logits, f32 softmax
statistics, probabilities cast to the activation dtype BEFORE the PV product,
f32 PV accumulation, and the 1/sum factor applied to the accumulator.
"""

from __future__ import annotations

import torch

from image_search_tpu_torch import _build

NEG_INF = torch.finfo(torch.float32).min
SUPPORTED_HEAD_DIMS = (64,)  # 80 (H/14) and 104 (bigG) come with the model ladder


def attention_reference(q, k, v, causal: bool = False, sm_scale: float = 1.0):
    """Plain attention over [B, S, H, Hd] -> [B, S, H, Hd] (output in q.dtype)."""
    dtype = q.dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        S = q.shape[1]
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    logits = logits - logits.amax(dim=-1, keepdim=True)
    p32 = torch.exp(logits)
    recip = 1.0 / p32.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p32.to(dtype).float(), v.float())
    return (acc * recip).to(dtype).permute(0, 2, 1, 3)


def _check_cuda_operands(q, k, v, heads):
    B, S, DH = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"attention kernel: {name} must be bf16 on {q.device}, got {t.dtype} on {t.device}")
        if t.shape != q.shape:
            raise ValueError(f"attention kernel: {name} shape {tuple(t.shape)} != q {tuple(q.shape)}")
        if t.stride(2) != 1 or t.stride(0) != S * t.stride(1) or t.stride(1) % 2:
            raise ValueError(f"attention kernel: {name} must be row-strided [B, S, H*Hd], strides {t.stride()}")
    if DH % heads or DH // heads not in SUPPORTED_HEAD_DIMS:
        raise NotImplementedError(
            f"attention kernel: head dim {DH // heads if heads else '?'} not built "
            f"(built: {SUPPORTED_HEAD_DIMS})"
        )


def fused_attention(q, k, v, heads: int, causal: bool = False, sm_scale: float = 1.0):
    """Attention over the packed layout [B, S, H*Hd] -> [B, S, H*Hd].

    ``q``, ``k`` and ``v`` may be row-strided views (for example column
    blocks of one fused qkv projection); the last dim must be contiguous.
    """
    B, S, DH = q.shape
    if q.device.type == "cpu":
        Hd = DH // heads
        out = attention_reference(
            q.reshape(B, S, heads, Hd), k.reshape(B, S, heads, Hd),
            v.reshape(B, S, heads, Hd), causal=causal, sm_scale=sm_scale,
        )
        return out.reshape(B, S, DH)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no route for device {q.device}")
    _check_cuda_operands(q, k, v, heads)
    lib = _build.lib()
    Hd = DH // heads
    smem = lib.isx_attention_smem_bytes(S, Hd)
    limit = getattr(
        torch.cuda.get_device_properties(q.device), "shared_memory_per_block_optin", 232448
    )
    if smem > limit:
        raise ValueError(f"attention kernel: S={S} needs {smem} B of shared memory > {limit}")
    out = torch.empty((B, S, DH), dtype=q.dtype, device=q.device)
    rc = lib.isx_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, heads, Hd, q.stride(1), k.stride(1), v.stride(1), out.stride(1),
        int(causal), float(sm_scale), _build.stream_handle(q.device),
    )
    _build.check(rc, "attention kernel launch")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
