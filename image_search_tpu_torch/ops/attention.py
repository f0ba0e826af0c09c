"""Multi-head attention core: kernels B1 (forward) and B5 (backward), each
with its plain PyTorch version.

- ``fused_attention`` is the port of ``image_search_tpu/ops/attention.py::
  fused_attention_grouped`` (Pallas ``_attn_kernel_grouped``), which runs
  every attention layer of both CLIP towers except the CLS/EOS-only last one.
  On a CUDA tensor it launches ``csrc/attention.cu``; on a CPU tensor it runs
  :func:`attention_reference`. It follows the grouped kernel's rounding
  points: f32 logits, f32 softmax statistics, probabilities cast to the
  activation dtype BEFORE the PV product, f32 PV accumulation, and the 1/sum
  factor applied to the accumulator.
- ``fused_attention_bwd`` is the port of ``fused_attention_bwd`` (Pallas
  ``_attn_bwd_kernel``): dq, dk and dv from the output cotangent, with the
  probabilities recomputed in f32. On a CUDA tensor it launches
  ``csrc/attention_bwd.cu``; on a CPU tensor it runs
  :func:`attention_bwd_reference`.
- :class:`AttentionCore` joins the two as one differentiable op, as the
  reference's ``attention_grouped_core`` custom VJP does.

There is no other route: a CUDA tensor a kernel cannot take raises.
"""

from __future__ import annotations

import torch

from image_search_tpu_torch import _build

NEG_INF = torch.finfo(torch.float32).min
SUPPORTED_HEAD_DIMS = (64,)  # 80 (H/14) and 104 (bigG) come with the model ladder


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its accumulation type: f32 for bf16/f16/f32, f64 for f64 (so
    that gradient checks in f64 see the same function)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _logits(q, k, causal: bool, sm_scale: float):
    """[B, S, H, Hd] q, k -> [B, H, S, S] logits in the accumulation type,
    masked positions at NEG_INF (never -inf)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", _acc(q), _acc(k)) * sm_scale
    if causal:
        S = q.shape[1]
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    return logits - logits.amax(dim=-1, keepdim=True)


def attention_reference(q, k, v, causal: bool = False, sm_scale: float = 1.0):
    """Plain attention over [B, S, H, Hd] -> [B, S, H, Hd] (output in q.dtype)."""
    dtype = q.dtype
    p32 = torch.exp(_logits(q, k, causal, sm_scale))
    recip = 1.0 / p32.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", _acc(p32.to(dtype)), _acc(v))
    return (acc * recip).to(dtype).permute(0, 2, 1, 3)


def attention_bwd_reference(q, k, v, g, heads: int, causal: bool = False, sm_scale: float = 1.0):
    """Plain B5: (dq, dk, dv) of attention over the packed [B, S, H*Hd] layout
    from the output cotangent ``g``, each in q.dtype.

    The rounding points of ``_attn_bwd_kernel``: f32 logits, p32 = exp(l -
    max) / sum (a division), dv = bf16(p32)^T g, dp = g v^T, ds = p32 (dp -
    sum_k dp p32), dsb = (ds * sm_scale) in the input dtype, dq = dsb k and
    dk = dsb^T q, every product accumulated in f32.
    """
    B, S, DH = q.shape
    Hd = DH // heads
    dtype = q.dtype
    split = lambda t: t.reshape(B, S, heads, Hd)
    q4, k4, v4, g4 = split(q), split(k), split(v), split(g)
    p32 = torch.exp(_logits(q4, k4, causal, sm_scale))
    p32 = p32 / p32.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bqhd->bkhd", _acc(p32.to(dtype)), _acc(g4))
    dp = torch.einsum("bqhd,bkhd->bhqk", _acc(g4), _acc(v4))
    ds = p32 * (dp - (dp * p32).sum(dim=-1, keepdim=True))
    dsb = _acc((ds * sm_scale).to(dtype))
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, _acc(k4))
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, _acc(q4))
    return tuple(t.to(dtype).reshape(B, S, DH) for t in (dq, dk, dv))


def _check_cuda_operands(heads, q, k, v, *more):
    B, S, DH = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), *(("g", t) for t in more)):
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


def _check_smem(device, smem: int, S: int) -> None:
    limit = getattr(torch.cuda.get_device_properties(device), "shared_memory_per_block_optin", 232448)
    if smem > limit:
        raise ValueError(f"attention kernel: S={S} needs {smem} B of shared memory > {limit}")


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
    _check_cuda_operands(heads, q, k, v)
    lib = _build.lib()
    Hd = DH // heads
    _check_smem(q.device, lib.isx_attention_smem_bytes(S, Hd), S)
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


def fused_attention_bwd(q, k, v, g, heads: int, causal: bool = False, sm_scale: float = 1.0):
    """(dq, dk, dv) of :func:`fused_attention` over the packed [B, S, H*Hd]
    layout, from the output cotangent ``g``; each a new contiguous tensor in
    q.dtype. Operands may be row-strided views, as for the forward."""
    B, S, DH = q.shape
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, g, heads, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd: no route for device {q.device}")
    _check_cuda_operands(heads, q, k, v, g)
    lib = _build.lib()
    Hd = DH // heads
    _check_smem(q.device, lib.isx_attention_bwd_smem_bytes(S, Hd), S)
    dq, dk, dv = (torch.empty((B, S, DH), dtype=q.dtype, device=q.device) for _ in range(3))
    stats = torch.empty((3, B, heads, S), dtype=torch.float32, device=q.device)
    rc = lib.isx_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        B, S, heads, Hd, q.stride(1), k.stride(1), v.stride(1), g.stride(1),
        int(causal), float(sm_scale), _build.stream_handle(q.device),
    )
    _build.check(rc, "attention backward kernel launch")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0


class AttentionCore(torch.autograd.Function):
    """Differentiable attention core over the packed layout: forward B1
    (:func:`fused_attention`), backward B5 (:func:`fused_attention_bwd`).
    Saves q, k and v for the backward, as ``_grouped_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, causal: bool, sm_scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.args = (heads, causal, sm_scale)
        return fused_attention(q, k, v, heads, causal, sm_scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*fused_attention_bwd(q, k, v, g.contiguous(), *ctx.args), None, None, None)
