"""Single-device contrastive fine-tuning of the CLIP towers (port of
``image_search_tpu/train``)."""

from image_search_tpu_torch.train.contrastive import TrainState, clip_loss, make_train_step
from image_search_tpu_torch.train.eval import evaluate_pairs

__all__ = ["TrainState", "clip_loss", "make_train_step", "evaluate_pairs"]
