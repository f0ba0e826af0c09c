"""What the drivers share: a cell's inputs, the engine built through the
server's own argument parser with the harness's weights, and clean-up."""

from __future__ import annotations

import dataclasses
import gc
import logging
import threading
import time

from bench_port import model_config, weights


@dataclasses.dataclass
class Cell:
    """One run's inputs: the cell's name, its configuration file and mix
    (as dicts, so tests can pass small ones), ``--seed``, ``--seconds``,
    ``--trace``, the device, a scratch directory the run owns, and the
    ``time.perf_counter()`` reading at the process's start (set-up counts
    from it)."""

    name: str
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    tmp: str
    start: float

    @property
    def model(self) -> dict:
        return model_config.model(self.config)


def quiet_program_logs() -> None:
    """The program's INFO lines would bury the run's own last lines."""
    logging.getLogger("image_search_tpu_torch").setLevel(logging.WARNING)


def build_engine(torch, cell: Cell, media_dir: str, index_dir: str):
    """The port's ``SearchEngine`` from the server's own flags (the
    configuration's deployment flags), holding the harness's weights for
    ``--seed`` (the engine starts on its demo weights; they are replaced
    before any request)."""
    from image_search_tpu_torch.server import app

    argv = ["--media-dir", media_dir, "--index-dir", index_dir, "--model", cell.config["preset"],
            "--model-weights", index_dir + "/absent.safetensors", "--device", str(cell.device)]
    argv += list(cell.config["deployment"]["flags"])
    args, device = app.parse_args(argv)
    from image_search_tpu_torch.server.engine import SearchEngine

    engine = SearchEngine(args, device=device)
    model_config.check_against_preset(cell.config, engine.cfg)
    state = weights.make(cell.model, cell.seed, cell.device, engine.embedder.compute_dtype)
    engine.embedder.model.load_state_dict(state, strict=True)
    del state
    return engine, args


def join_threads(prefix: str, timeout: float = 300.0) -> None:
    """Wait for the program's background threads named ``prefix...``."""
    deadline = time.monotonic() + timeout
    for t in threading.enumerate():
        if t.name.startswith(prefix) and t is not threading.current_thread():
            t.join(max(0.0, deadline - time.monotonic()))


def peak_bytes(torch, device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def free(torch, device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
