"""Server CLI — flag names/semantics mirror the reference
(the upstream server's ``server/src/server_arguments.rs:7-28``), with the five
``--surrealdb-*`` flags replaced by index/mesh flags (the DB process no
longer exists; SURVEY.md §5 config row).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class ServerArgs:
    model_weights: str = "./models/clip.safetensors"
    media_dir: str = "~/Pictures"
    chunk_size: int = 500
    addr: str = "127.0.0.1"
    port: int = 3000
    # new (replace --surrealdb-*):
    index_dir: str = "./index"
    index_quantize: Optional[str] = None  # None|bfloat16|int8 row storage
    index_capacity: Optional[int] = None  # preallocate slabs for N rows
    tokenizer_dir: Optional[str] = None
    model: str = "clip-vit-large-patch14"
    from_hf: Optional[str] = None  # hub id / local HF dir / "auto"
    preprocess_mode: str = "hf"
    compute_dtype: str = "auto"  # auto|float32|bfloat16
    mesh_data: Optional[int] = None  # None => all devices
    mesh_model: int = 1
    decode_workers: int = 16
    # persistent decoded-tile cache dir: rescans/model upgrades skip full
    # decode entirely (ingest/thumbcache.py); empty = disabled
    thumb_cache: str = ""
    k: int = 1000  # reference hardcodes 1000 (search.rs:76); we expose it
    search_approx: bool = False  # lax.approx_max_k (recall 0.95): ~2.3x faster
    search_twostage: bool = False  # certified exact sketch+rescore (twostage.py)
    sketch_dtype: str = "float32"  # float32|bfloat16: bf16 halves stage-1 bytes
    # coalesced micro-batches LARGER than this answer by full scan (its
    # one read amortizes across the batch). The union selection keeps
    # distinct batches certified through B=8 on f32 sketches (measured
    # 1.87 ms/q vs 2.13 full at 10M) so 8 is a valid setting there; the
    # default stays 4 — biggest per-query win, and the bf16 sketch
    # measured certified only to B=1 at the default budget
    twostage_max_batch: int = 4
    # build-time certifiability gate: a sketch whose estimated certifiable
    # query fraction (replayed on the row sample) is below this is NOT
    # published — a flat corpus then never pays a doomed bound pass. 0
    # disables the gate (always publish; adaptive disable still protects)
    twostage_min_certifiable: float = 0.5
    prune_on_scan: bool = False  # tombstone indexed images whose files vanished
    batch_window_ms: float = 0.0  # >0: coalesce concurrent searches
    static_dir: Optional[str] = None
    profiler_port: Optional[int] = None  # jax.profiler trace server

    def expanded_media_dir(self) -> str:
        # shellexpand_media_dir (server_arguments.rs:35-37)
        return os.path.expanduser(self.media_dir)


def build_parser() -> argparse.ArgumentParser:
    d = ServerArgs()
    p = argparse.ArgumentParser(
        prog="image-search-tpu",
        description="TPU-native semantic photo search server",
    )
    p.add_argument("-w", "--model-weights", default=d.model_weights,
                   help="checkpoint (safetensors) with both CLIP towers")
    p.add_argument("-m", "--media-dir", default=d.media_dir)
    p.add_argument("-c", "--chunk-size", type=int, default=d.chunk_size)
    p.add_argument("-a", "--addr", default=d.addr)
    p.add_argument("-p", "--port", type=int, default=d.port)
    p.add_argument("--index-dir", default=d.index_dir,
                   help="embedding store directory (replaces SurrealDB)")
    p.add_argument("--index-quantize", choices=["bfloat16", "int8"], default=d.index_quantize,
                   help="device row storage (int8 fits 10M vectors on one chip)")
    p.add_argument("--index-capacity", type=int, default=d.index_capacity,
                   help="preallocate device slabs for this many rows: ingest "
                        "performs zero device allocations (10M-scale OOM "
                        "hardening; growth otherwise adds one slab at a time)")
    p.add_argument("--tokenizer-dir", default=d.tokenizer_dir,
                   help="dir with vocab.json+merges.txt (CLIP BPE)")
    p.add_argument("--model", default=d.model,
                   help="model preset when --model-weights doesn't exist")
    p.add_argument("--from-hf", default=d.from_hf, dest="from_hf",
                   help="when --model-weights is missing, fetch+convert this "
                        "HF hub id (or local HF dir; 'auto' = the preset's "
                        "canonical repo) into --model-weights at startup — "
                        "the runtime equivalent of the reference's build-time "
                        "weight download (clip/build.rs:9-11)")
    p.add_argument("--preprocess-mode", choices=["hf", "reference"], default=d.preprocess_mode)
    p.add_argument("--compute-dtype", choices=["auto", "float32", "bfloat16"],
                   default=d.compute_dtype)
    p.add_argument("--mesh-data", type=int, default=d.mesh_data)
    p.add_argument("--mesh-model", type=int, default=d.mesh_model)
    p.add_argument("--decode-workers", type=int, default=d.decode_workers)
    p.add_argument("--thumb-cache", dest="thumb_cache", default=d.thumb_cache,
                   help="dir for the persistent decoded-tile cache; rescans "
                        "and re-embeddings skip full image decode")
    p.add_argument("--k", type=int, default=d.k)
    p.add_argument("--batch-window-ms", type=float, default=d.batch_window_ms,
                   help="coalesce concurrent text searches arriving within "
                        "this window into one device batch (0 = off)")
    p.add_argument("--search-approx", action="store_true", default=d.search_approx,
                   help="approx top-k (recall 0.95, ~2.3x faster at 10M+ rows; "
                        "still better fidelity than the reference's MTREE)")
    p.add_argument("--search-twostage", action="store_true",
                   default=d.search_twostage,
                   help="two-stage EXACT search: sketch-bound pass + certified "
                        "rescore, full-scan fallback when the certificate "
                        "fails — beats the HBM-read floor on spectrally "
                        "concentrated (realistic) corpora")
    p.add_argument("--sketch-dtype", choices=["float32", "bfloat16"],
                   default=d.sketch_dtype,
                   help="two-stage sketch storage: bfloat16 halves the "
                        "bound-pass HBM bytes (still certified-exact; the "
                        "rounding cost is folded into the bound)")
    p.add_argument("--twostage-max-batch", type=int,
                   default=d.twostage_max_batch,
                   help="largest coalesced batch that rides the two-stage "
                        "path; bigger batches answer by full scan (which "
                        "amortizes its read across the batch). f32 sketches "
                        "measured certified through 8; keep <=1 for "
                        "--sketch-dtype bfloat16 under heavy batching")
    p.add_argument("--twostage-min-certifiable", type=float,
                   default=d.twostage_min_certifiable,
                   help="skip publishing a two-stage sketch whose build-time "
                        "estimated certifiable query fraction is below this "
                        "(flat corpora then go straight to the full scan "
                        "instead of paying failed bound passes); 0 disables")
    p.add_argument("--prune-on-scan", action="store_true", default=d.prune_on_scan,
                   help="each scan also tombstones indexed images whose files "
                        "no longer exist (the reference keeps them forever)")
    p.add_argument("--static-dir", default=d.static_dir,
                   help="SPA dist dir (defaults to the bundled client)")
    p.add_argument("--profiler-port", type=int, default=d.profiler_port,
                   help="start a jax.profiler trace server on this port")
    return p


def parse_args(argv=None) -> ServerArgs:
    ns = build_parser().parse_args(argv)
    return ServerArgs(**{k.replace("-", "_"): v for k, v in vars(ns).items()})
