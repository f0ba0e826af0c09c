"""A miniature configuration and mixes for the CPU tests: the program's
``clip-tiny-test`` preset, a corpus of thousands of rows, a few seconds."""

import copy

TINY_CONFIG = {
    "name": "clip-tiny",
    "source": "tests",
    "preset": "clip-tiny-test",
    "reduced": {},
    "text_config": {"hidden_size": 64, "intermediate_size": 256, "num_attention_heads": 4, "num_hidden_layers": 2,
                    "max_position_embeddings": 16, "vocab_size": 128, "hidden_act": "quick_gelu",
                    "layer_norm_eps": 1e-05},
    "vision_config": {"hidden_size": 96, "intermediate_size": 384, "num_attention_heads": 4, "num_hidden_layers": 2,
                      "image_size": 28, "patch_size": 14, "hidden_act": "quick_gelu", "layer_norm_eps": 1e-05},
    "projection_dim": 32,
    "logit_scale_init_value": 2.6592,
    "tokenizer": {"eos_token_id": 127},
    "deployment": {"flags": ["--index-quantize", "int8", "--batch-window-ms", "2", "--k", "50"]},
}

SEARCH_MIX = {
    "kind": "search",
    "corpus": {"rows": 20000, "block_rows": 8192, "rank": 8, "noise": 0.02},
    "rate_per_s": 40,
    "burst": None,
    "new_share": 0.4,
    "words": [3, 12],
    "vocabulary": 512,
    "marks": [1, 5],
    "mark_from_top": 20,
    "think_s": [0.3, 1.0],
    "warmup_s": 1.5,
    "check_requests": 16,
    "limits": {"score_gap": 0.02, "rank_gap": 0.02},
}

SCAN_MIX = {
    "kind": "scan",
    "pool": 6,
    "long_side": 200,
    "short_side": 150,
    "portrait_share": 0.25,
    "grain": 4.0,
    "jpeg_quality": 92,
    "warm_chunks": 2,
    "max_img_per_s": 400,
    "lead_s": 2,
    "check_photos": 4,
    "limits": {"emb_rel_err": 0.02},
}

FINETUNE_MIX = {
    "kind": "finetune",
    "pairs": 8,
    "batch_size": 8,
    "long_side": [64, 96],
    "grain": 4.0,
    "jpeg_quality": 90,
    "caption_words": [5, 20],
    "vocabulary": 512,
    "warm_steps": 1,
    "lr": 1e-5,
    "limits": {"loss_gap": 1e-3, "grad_gap": 1e-2, "step_gap": 1e-2},
}


def config(chunk: int = 0):
    """The tiny configuration; ``chunk`` > 0 sets the scan's chunk size."""
    cfg = copy.deepcopy(TINY_CONFIG)
    if chunk:
        cfg["deployment"]["flags"] += ["--chunk-size", str(chunk), "--decode-workers", "4"]
    return cfg


