from image_search_tpu_torch.tokenizer.bpe import CLIPBPETokenizer, HashTokenizer, train_bpe

__all__ = ["CLIPBPETokenizer", "HashTokenizer", "train_bpe"]
