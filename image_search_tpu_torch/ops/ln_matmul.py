"""Fused LayerNorm -> matmul: kernel B9 with its plain PyTorch version.

``ln_matmul`` is the port of ``image_search_tpu/ops/ln_matmul.py::ln_matmul``
(Pallas ``_ln_mm_kernel``): ``LayerNorm(x) @ w^T + b`` with the LayerNorm
computed in the matmul's prologue, so the normalised activation never
reaches device memory. On a CUDA tensor it launches ``csrc/ln_matmul.cu``;
on a CPU tensor it runs :func:`ln_matmul_reference`. There is no other
route: a CUDA tensor the kernel cannot take raises.

The weight is in ``nn.Linear``'s ``[N, K]`` layout, so a block's
``qkv.weight`` and ``fc.weight`` go in as they are; the reference's ``w`` is
``[K, N]``, its transpose. The reference's ``pick_block_m`` (a TPU VMEM
budget) has no counterpart: the CUDA kernel's tiles are fixed.

:class:`LnMatmulCore` makes it differentiable as the reference's
``ln_matmul_core`` does: the forward is the kernel, the backward autodiff of
the plain version.

One call launches twice on the current stream: a pass that computes each
row's mean and rstd into a [2, M] f32 scratch, then the GEMM, which
normalises x on its way into the tensor cores. ``ln_matmul.launches``
counts calls.
"""

from __future__ import annotations

import torch

from image_search_tpu_torch import _build


def ln_matmul_reference(x, ln_scale, ln_bias, w, b, eps: float = 1e-5):
    """Plain B9: x [M, K], w [N, K], b [N] -> [M, N] in x.dtype.

    The kernel's rounding points: two-pass f32 statistics over K (the mean,
    then the mean of centred squares), ``rsqrt(var + eps)``, the f32 affine,
    y rounded to w.dtype, the product accumulated in f32 and cast to the
    output dtype, then ``+ b`` in that dtype."""
    acc_t = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc_t)
    mean = x32.mean(dim=-1, keepdim=True)
    cent = x32 - mean
    var = (cent * cent).mean(dim=-1, keepdim=True)
    y = cent * torch.rsqrt(var + eps)
    y = y * ln_scale.to(acc_t) + ln_bias.to(acc_t)
    acc = torch.matmul(y.to(w.dtype).to(acc_t), w.to(acc_t).t())
    return acc.to(x.dtype) + b.to(x.dtype)


def _check_cuda_operands(x, ln_scale, ln_bias, w, b):
    M, K = x.shape
    N = w.shape[0]
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device or t.dtype != torch.bfloat16:
            raise ValueError(f"ln_matmul kernel: {name} must be bf16 on {x.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"ln_matmul kernel: {name} must be contiguous and 16-byte aligned")
    for name, t in (("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        if t.device != x.device or not t.is_floating_point() or t.shape != (K,):
            raise ValueError(f"ln_matmul kernel: {name} must be a float [{K}] on {x.device}")
    if w.shape != (N, K) or b.shape != (N,):
        raise ValueError(f"ln_matmul kernel: w {tuple(w.shape)} and b {tuple(b.shape)} must be [N, {K}] and [N]")
    if K % 8 or N % 8:
        raise ValueError(f"ln_matmul kernel: K={K} and N={N} must be multiples of 8")


def ln_matmul(x, ln_scale, ln_bias, w, b, eps: float = 1e-5):
    """``LayerNorm(x; ln_scale, ln_bias, eps) @ w^T + b``: x [M, K], w [N, K]
    (``nn.Linear``'s layout), b [N] -> [M, N] in x.dtype."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"ln_matmul: x and w must be 2-d, got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.device.type == "cpu":
        return ln_matmul_reference(x, ln_scale, ln_bias, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_matmul: no route for device {x.device}")
    _check_cuda_operands(x, ln_scale, ln_bias, w, b)
    M, K = x.shape
    N = w.shape[0]
    lsb = torch.stack([t.to(torch.float32) for t in (ln_scale, ln_bias)])
    stats = torch.empty((2, M), dtype=torch.float32, device=x.device)  # each row's mean and rstd
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = _build.lib().isx_ln_matmul(
        x.data_ptr(), lsb.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), stats.data_ptr(),
        M, N, K, float(eps), _build.stream_handle(x.device),
    )
    _build.check(rc, "ln_matmul kernel launch")
    ln_matmul.launches += 1
    return out


ln_matmul.launches = 0


class LnMatmulCore(torch.autograd.Function):
    """Differentiable :func:`ln_matmul`: the kernel forward, the gradient of
    every input by autodiff of :func:`ln_matmul_reference` (the reference's
    ``ln_matmul_core`` VJP). Saves the inputs for the backward."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w, b, eps: float = 1e-5):
        ctx.save_for_backward(x, ln_scale, ln_bias, w, b)
        ctx.eps = eps
        return ln_matmul(x, ln_scale, ln_bias, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            grads = torch.autograd.grad(ln_matmul_reference(*leaves, eps=ctx.eps), leaves, g)
        return (*grads, None)
