"""Dual-tower embedding engine: batch bucketing around the CLIP towers.

Port of ``image_search_tpu/models/embedder.py::ClipEmbedder``. Images enter
as uint8 plus per-image resize matrices (``ops.preprocess.pack_batch``) and
run preprocess + vision tower on the device; texts are tokenized on the host
and padded with EOS rows to the same power-of-two buckets. PyTorch dispatch
is asynchronous: the ``*_async``/``*_device`` calls return device tensors
without waiting, which is what lets the scan pipeline decode chunk N+1 while
chunk N embeds.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from image_search_tpu_torch.models.clip import CLIP, encode_image, encode_text
from image_search_tpu_torch.ops.preprocess import fused_preprocess, pack_batch
from image_search_tpu_torch.utils.metrics import span

# Largest batch one dispatch embeds; bigger inputs split into sub-batches.
# 160 is the TPU v5e optimum of the reference; the H100 value is still to be
# measured (PERF.md, Open questions).
MAX_DEVICE_BATCH = 160


def _bucket_batch(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n and b < 128:
        b *= 2
    if n <= b:
        return b
    return MAX_DEVICE_BATCH  # 129..160 (larger inputs were split upstream)


class ClipEmbedder:
    """Text/image embedding on one device with batch bucketing."""

    def __init__(self, model: CLIP, tokenizer=None, preprocess_mode: str = "hf", mesh=None):
        cfg = model.cfg
        if cfg.arch != "clip":
            raise NotImplementedError(f"arch {cfg.arch!r}: only CLIP is ported so far")
        if mesh is not None:
            raise NotImplementedError("device meshes are not ported yet")
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.preprocess_mode = preprocess_mode
        self.device = model.device
        self.compute_dtype = model.dtype
        if tokenizer is not None and getattr(tokenizer, "eos_id", None) is not None:
            if tokenizer.eos_id != cfg.text.eos_token_id:
                # encode_text pools at the first cfg EOS; a mismatched
                # tokenizer would silently pool at position 0 for every text
                raise ValueError(
                    f"tokenizer eos_id {tokenizer.eos_id} != model "
                    f"eos_token_id {cfg.text.eos_token_id}"
                )

    # -- image path -----------------------------------------------------------

    def embed_images(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """uint8 HWC arrays (any sizes) -> raw [N, projection_dim] f32."""
        if len(images) == 0:
            return np.zeros((0, self.cfg.projection_dim), np.float32)
        out = self.embed_images_async(images)
        return out[: len(images)].float().cpu().numpy()

    def embed_images_async(self, images: Sequence[np.ndarray], min_bucket: int = 8) -> torch.Tensor:
        """Dispatch without waiting; returns the (bucket-padded) device tensor
        of raw embeddings in the compute dtype. ``min_bucket=1`` serves a
        query image (``/search_image``): one photo runs at B=1, not padded
        to the ingest floor of 8."""
        if len(images) > MAX_DEVICE_BATCH:
            parts = [
                self._embed_one_batch(images[lo : lo + MAX_DEVICE_BATCH])[
                    : min(MAX_DEVICE_BATCH, len(images) - lo)
                ]
                for lo in range(0, len(images), MAX_DEVICE_BATCH)
            ]
            return torch.cat(parts, dim=0)
        return self._embed_one_batch(images, min_bucket)

    def _embed_one_batch(self, images: Sequence[np.ndarray], min_bucket: int = 8) -> torch.Tensor:
        with span("image.preprocess"):  # the resize matrices at the tower's image size, copies, fused preprocess
            u8, A_h, A_w = pack_batch(images, size=self.cfg.vision.image_size, mode=self.preprocess_mode)
            n = len(images)
            B = _bucket_batch(n, min_bucket)
            if B > n:  # pad batch; padded rows are discarded by the caller
                pad = B - n
                u8 = np.concatenate([u8, np.zeros((pad,) + u8.shape[1:], u8.dtype)])
                A_h = np.concatenate([A_h, np.zeros((pad,) + A_h.shape[1:], A_h.dtype)])
                A_w = np.concatenate([A_w, np.zeros((pad,) + A_w.shape[1:], A_w.dtype)])
            with torch.inference_mode():
                u8, A_h, A_w = (torch.from_numpy(a).to(self.device) for a in (u8, A_h, A_w))
                pixels = fused_preprocess(
                    u8, A_h, A_w, mode=self.preprocess_mode, out_dtype=self.compute_dtype
                )
        with torch.inference_mode():
            return encode_image(self.model, pixels)

    # -- text path -------------------------------------------------------------

    def encode_text_fn(self, ids: torch.Tensor) -> torch.Tensor:
        """The text tower on token ids already on the device: [B, L] ->
        raw [B, projection_dim], in the compute dtype (the fused two-stage
        serving path, ``VectorIndex.search_twostage_fused_tokens``)."""
        with torch.inference_mode():
            return encode_text(self.model, ids)

    def embed_texts_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Strings -> raw [N, projection_dim] embeddings left on the device."""
        if self.tokenizer is None:
            raise ValueError("embedder constructed without a tokenizer")
        n = len(texts)
        ids = self.tokenizer(list(texts))
        B = _bucket_batch(n)
        if B > n:
            pad_row = np.full((B - n, ids.shape[1]), self.tokenizer.eos_id, ids.dtype)
            ids = np.concatenate([ids, pad_row])
        return self.encode_text_fn(torch.from_numpy(ids.astype(np.int64)).to(self.device))[:n]

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Strings -> raw [N, projection_dim] f32 (tokenize + text tower)."""
        return self.embed_texts_device(texts).float().cpu().numpy()
