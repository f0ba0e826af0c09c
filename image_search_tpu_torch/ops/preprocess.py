"""On-device image preprocessing (resize + crop + normalize) in PyTorch.

Port of ``image_search_tpu/ops/preprocess.py``. The host computes per-image
PIL-compatible bicubic resize(+crop) matrices and packs uint8 pixels into one
padded batch (the numpy helpers below are carried over unchanged); the device
runs :func:`fused_preprocess`: two resample einsums with PIL's
``clip(floor(v + 0.5))`` between them, then /255 and mean/std. Both einsums
are plain XLA in the reference, so they are plain torch here. They must run
in full f32 (``image_search_tpu_torch.check_precision``): TF32 would move
values across the uint8 rounding between the passes.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

# HF CLIPImageProcessor constants (openai/clip-vit-large-patch14).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# The reference (mistakenly, vs CLIP training) uses ImageNet constants
# (clip.rs:157-159); kept for bit-compat with its stored embeddings.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys bicubic kernel, a=-0.5 (PIL BICUBIC == image-crate CatmullRom)."""
    ax = np.abs(x)
    return np.where(
        ax < 1.0,
        ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
        np.where(ax < 2.0, (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a, 0.0),
    )


@lru_cache(maxsize=4096)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] PIL-compatible bicubic resampling matrix.

    Replicates PIL's ``precompute_coeffs``: support scaled by the downscale
    factor (antialiasing), per-row weight normalization. f64 internally,
    f32 out.
    """
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale  # bicubic support = 2
    A = np.zeros((out_size, in_size), np.float64)
    for o in range(out_size):
        center = (o + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)  # PIL: floor(center-support+0.5)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax, dtype=np.float64)
        w = _bicubic((xs - center + 0.5) / filterscale)
        s = w.sum()
        if s != 0.0:
            w = w / s
        A[o, xmin:xmax] = w
    return A.astype(np.float32)


def _crop_window(resized: int, crop: int) -> int:
    """HF center_crop top/left offset."""
    return (resized - crop) // 2


def preprocess_matrices(
    h: int,
    w: int,
    *,
    size: int = 224,
    mode: str = "hf",
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-image (A_h [size, h], A_w [size, w]) resize(+crop) matrices.

    mode="hf":        shortest-edge resize to `size`, center crop `size`
                      (HF CLIPImageProcessor policy — the parity target).
    mode="reference": resize_exact to (size, size), aspect-distorting
                      (clip.rs:154).
    """
    if mode == "reference":
        return resize_matrix(h, size), resize_matrix(w, size)
    if mode != "hf":
        raise ValueError(f"unknown preprocess mode {mode!r}")
    # HF get_resize_output_image_size: scale shortest edge to `size`,
    # round the other edge.
    short, long = (h, w) if h <= w else (w, h)
    new_short = size
    new_long = int(size * long / short)
    rh, rw = (new_short, new_long) if h <= w else (new_long, new_short)
    A_h = resize_matrix(h, rh)
    A_w = resize_matrix(w, rw)
    top = _crop_window(rh, size)
    left = _crop_window(rw, size)
    return A_h[top : top + size], A_w[left : left + size]


def _stats(mode: str):
    if mode == "hf":
        return CLIP_MEAN, CLIP_STD
    return IMAGENET_MEAN, IMAGENET_STD


def fused_preprocess(
    images_u8: torch.Tensor,  # [B, H, W, 3] uint8 (H/W padded to a bucket)
    A_h: torch.Tensor,  # [B, size, H] f32 (zero cols over padding)
    A_w: torch.Tensor,  # [B, size, W] f32
    mode: str = "hf",
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 HWC batch -> normalized [B, size, size, 3] (NHWC).

    Pass order and the clamp+round between passes replicate PIL's uint8
    two-pass resample (horizontal first, u8 intermediate)."""
    mean, std = _stats(mode)

    def _u8(v):  # PIL clip8(round(v))
        return torch.clamp(torch.floor(v + 0.5), 0.0, 255.0)

    x = images_u8.float()
    x = _u8(torch.einsum("bpw,bhwc->bhpc", A_w, x))  # horizontal resample
    x = _u8(torch.einsum("boh,bhpc->bopc", A_h, x))  # vertical resample
    x = x * (1.0 / 255.0)
    mean_a = torch.tensor(mean, dtype=torch.float32, device=x.device)
    inv_std = 1.0 / torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean_a) * inv_std).to(out_dtype)


# ---------------------------------------------------------------------------
# Host-side batch assembly
# ---------------------------------------------------------------------------

_BUCKETS = (256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return int(math.ceil(n / 1024) * 1024)


def pack_batch(
    images: Sequence[np.ndarray],
    *,
    size: int = 224,
    mode: str = "hf",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack variably-sized uint8 HWC images into one padded device batch.

    Returns (images_u8 [B, Hb, Wb, 3], A_h [B, size, Hb], A_w [B, size, Wb])
    where (Hb, Wb) are the smallest size buckets covering the batch. Padding
    pixels get zero filter weight, so they never leak into the output —
    verified in tests/test_preprocess.py.
    """
    assert images, "empty batch"
    hb = _bucket(max(im.shape[0] for im in images))
    wb = _bucket(max(im.shape[1] for im in images))
    B = len(images)
    out = np.zeros((B, hb, wb, 3), np.uint8)
    A_h = np.zeros((B, size, hb), np.float32)
    A_w = np.zeros((B, size, wb), np.float32)
    for i, im in enumerate(images):
        if im.ndim == 2:  # grayscale -> RGB
            im = np.repeat(im[:, :, None], 3, axis=2)
        if im.shape[2] == 4:  # RGBA -> RGB (white-matte like PIL convert)
            im = im[:, :, :3]
        h, w = im.shape[:2]
        out[i, :h, :w] = im
        ah, aw = preprocess_matrices(h, w, size=size, mode=mode)
        A_h[i, :, :h] = ah
        A_w[i, :, :w] = aw
    return out, A_h, A_w
