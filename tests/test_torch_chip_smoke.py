"""chip_smoke.py refuses to run without a GPU: importing it runs nothing,
and running it where ``torch.cuda.is_available()`` is false exits non-zero
before any phase, printing no result."""

import contextlib
import importlib.util
import io
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def test_import_has_no_side_effects():
    out = io.StringIO()
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    with contextlib.redirect_stdout(out):
        spec.loader.exec_module(mod)
    assert out.getvalue() == ""
    assert callable(mod.main)
    with open(SCRIPT) as f:
        imported = re.findall(r"^\s*(?:from|import) (\S+)", f.read(), re.M)
    assert not [m for m in imported if m.split(".")[0] in ("jax", "jaxlib")]
    # nothing of the JAX package either: the port keeps its own copies
    assert not [m for m in imported if m.split(".")[0] == "image_search_tpu"]
    assert "image_search_tpu_torch.config" in imported


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_exits_nonzero_without_gpu(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the script would run")
    if where == "alone":
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SCRIPT, script)
        cwd = str(tmp_path)
    else:
        script, cwd = SCRIPT, REPO
    proc = subprocess.run(
        [sys.executable, script], cwd=cwd, capture_output=True, text=True, timeout=180,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert proc.returncode != 0
    assert proc.stdout == ""  # no phase ran, no result line
    assert "is_available() is False" in proc.stderr


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kernels_line_lists_every_ported_kernel():
    """The ``kernels`` line's entries (the ``entry(...)`` calls in ``main``):
    B1, B1p, B2, B3, B4, B5, B6, B7, B8 and B9, then B1, B1p, B6 and B7 at
    the ladder's head dims 80 and 104, each naming a source that exists and
    the line of the Pallas kernel body it replaces."""
    import ast

    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [n for n in ast.walk(main) if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "entry"]
    rows = [tuple(a.value for a in c.args[:3]) for c in calls]
    assert [r[0] for r in rows] == [
        "fused_attention", "fused_attention_packed", "stream_scores_int8", "blockpair_mask",
        "blockpair_values", "fused_attention_bwd", "fused_attention_split_padded",
        "fused_attention_qkv_packed", "fused_qkv_attention", "ln_matmul",
    ]
    bodies = {
        "fused_attention": "_attn_kernel_grouped", "fused_attention_packed": "_attn_kernel",
        "stream_scores_int8": "_kernel", "blockpair_mask": "_kernel", "blockpair_values": "_values_kernel",
        "fused_attention_bwd": "_attn_bwd_kernel", "fused_attention_split_padded": "_attn_kernel_split",
        "fused_attention_qkv_packed": "_attn_kernel_packed", "fused_qkv_attention": "_qkv_attn_kernel",
        "ln_matmul": "_ln_mm_kernel",
    }
    # and the same kernels at the ladder's vision head dims (ladder_entries):
    # B1, B1p, B6 and B7 at H/14's 80 and bigG's 104, each from its own source
    mod = _load()
    assert mod.LADDER == {"openclip-vit-H-14": 80, "openclip-vit-bigG-14": 104}
    assert [e[0] for e in mod.LADDER_ENTRIES] == [
        "fused_attention", "fused_attention_packed", "fused_attention_split_padded", "fused_attention_qkv_packed",
    ]
    assert "ladder_entries(ladder)" in ast.unparse(main)
    rows += [(f"{name}_hd{hd}", f"attention_fwd_hd{hd}.cu", replaces)
             for hd in mod.LADDER.values() for name, replaces, _ in mod.LADDER_ENTRIES]
    for name, source, replaces in rows:
        assert os.path.exists(os.path.join(REPO, "image_search_tpu_torch", "csrc", source)), source
        path, line = replaces.split(":")
        with open(os.path.join(REPO, "image_search_tpu", "ops", path)) as f:
            text = f.read().splitlines()[int(line) - 1]
        assert text.startswith(f"def {bodies[name.split('_hd')[0]]}("), (name, text)


def test_route_switches_select_their_route_and_are_restored(monkeypatch):
    """Each phase's switches pick the route the smoke expects, and the
    environment is restored after the phase, set or unset before."""
    from image_search_tpu_torch.ops import attention
    from image_search_tpu_torch.ops.attention import attention_route, split_regime

    mod = _load()
    for name in mod.ROUTE_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ISX_ATTN_PIPE", "4")
    before = dict(os.environ)
    for route, (env, entry) in mod.ROUTE_SWITCHES.items():
        with mod.switches(env):
            assert all(os.environ[k] == v for k, v in env.items())
            if route == "padded":
                assert split_regime(257) and int(env["ISX_VIT_SPAD"]) == (257 // 128) * 128 + 8
            else:
                assert attention_route(257, 16, False) == route
        assert dict(os.environ) == before
        assert isinstance(getattr(attention, entry).launches, int)  # the wrapper the phase counts


def test_twostage_phase_runs_after_the_server_phases():
    """``main`` runs the two-stage phase (served over HTTP, then direct at 10M
    rows) after the server phases, and its launches reach the kernels line."""
    import ast

    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    phases = [n.func.id for n in ast.walk(main)
              if isinstance(n, ast.Call) and getattr(n.func, "id", "").startswith("phase_")]
    assert "phase_twostage" in phases
    assert phases.index("phase_twostage") > phases.index("phase_server_routes")
    mod = _load()
    assert mod.TWOSTAGE_ROWS == 10_000_000 and mod.TWOSTAGE_SLAB % 4096 == 0
    assert "ts_launches" in ast.unparse(main)


def test_serving_phase_runs_after_the_two_stage_phase():
    """``main`` runs the rest of the one-card server (batcher, /remove,
    thumbnail cache, bf16 rows, --search-approx) after the two-stage phase,
    whose corpus it frees, and its launches reach the kernels line."""
    import ast

    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    phases = [n.func.id for n in ast.walk(main)
              if isinstance(n, ast.Call) and getattr(n.func, "id", "").startswith("phase_")]
    assert phases.index("phase_serving") == phases.index("phase_twostage") + 1
    assert "sv_launches" in ast.unparse(main)
    mod = _load()
    assert mod.BF16_ROWS == 10_000_000 and (mod.SERVE_CLIENTS, mod.SERVE_ROUNDS) == (32, 8)


def test_launches_per_head_dim_are_read_and_reset(monkeypatch):
    """The smoke reads each attention forward entry point's launches per head
    dim as the wrapper counts them (``_count`` at the launch site), and its
    reset clears them with the totals."""
    from image_search_tpu_torch.ops import attention

    mod = _load()
    for fn in mod._kernel_counts():
        monkeypatch.setattr(fn, "launches", 0)
        if hasattr(fn, "launches_by_hd"):
            monkeypatch.setattr(fn, "launches_by_hd", {})
    attention._count(attention.fused_attention, 80)
    attention._count(attention.fused_attention, 80)
    attention._count(attention.fused_attention, 64)
    attention._count(attention.fused_attention_qkv_packed, 104)
    attention._count(attention.fused_attention_bwd, 32)
    assert mod._read_counts_by_hd() == {"fused_attention": {80: 2, 64: 1}, "fused_attention_qkv_packed": {104: 1},
                                        "fused_attention_bwd": {32: 1}}
    assert mod._read_counts()["fused_attention"] == 3
    mod._reset_counts()
    assert mod._read_counts_by_hd() == {}
    assert mod._read_counts()["fused_attention"] == 0


def test_kernels_line_lists_the_new_head_dims():
    """``new_head_dim_entries``: B5 at Hd 80 and 104 with the ladder
    fine-tune's launches at that head dim, B5 and B1 at 32 with the
    learned-retrieval gate's, B1p and B7 at 32 with the gate's towers on
    those routes; each names its own source and the Pallas body it
    replaces."""
    mod = _load()
    row = lambda err: dict(max_abs_err=err, ms=1.0, plain_ms=2.0, bound_ms=0.1, bound_by="bytes", library_ms=0.5,
                           shape="s", ragged_max_abs_err=err / 2)
    bwd = {(80, 257): row(0.1), (104, 257): row(0.2), (32, 65): row(0.3), (32, 16): row(0.4)}
    bwd |= {(hd, "ragged"): {"max_abs_err": 0.05} for hd in (32, 80, 104)}
    ladder = {"kernels": {32: {"packed": row(0.01), "qkv_packed": row(0.02), "grouped": row(0.03)}},
              "gate_b1": {65: row(0.04), 16: row(0.05)}}
    steps = lambda hd: {tag: {"launches_by_hd": {"fused_attention_bwd": {hd: n, 64: 7}}}
                        for tag, n in (("plain", 10), ("remat", 20))}
    train = {"steps": {"openclip-vit-H-14": steps(80), "openclip-vit-bigG-14": steps(104)}}
    learned = {"b1_launches": 5, "b5_launches": 4,
               "routes": {"packed": {"launches_by_hd": {"fused_attention_packed": {32: 3}}},
                          "fully fused": {"launches_by_hd": {"fused_attention_qkv_packed": {32: 2}}}}}
    rows = mod.new_head_dim_entries(bwd, ladder, train, learned)
    got = {r["name"]: (r["launches"], r["max_abs_err"], os.path.basename(r["source"]), r["replaces"]) for r in rows}
    assert got == {
        "fused_attention_bwd_hd80": (30, 0.1, "attention_bwd_hd80.cu", "image_search_tpu/ops/attention.py:122"),
        "fused_attention_bwd_hd104": (30, 0.2, "attention_bwd_hd104.cu", "image_search_tpu/ops/attention.py:122"),
        "fused_attention_bwd_hd32": (4, 0.4, "attention_bwd_hd32.cu", "image_search_tpu/ops/attention.py:122"),
        "fused_attention_hd32": (5, 0.05, "attention_fwd_hd32.cu", "image_search_tpu/ops/attention.py:665"),
        "fused_attention_packed_hd32": (3, 0.01, "attention_fwd_hd32.cu", "image_search_tpu/ops/attention.py:29"),
        "fused_attention_qkv_packed_hd32": (2, 0.02, "attention_fwd_hd32.cu", "image_search_tpu/ops/attention.py:276"),
    }
    bodies = {"122": "_attn_bwd_kernel", "665": "_attn_kernel_grouped", "29": "_attn_kernel", "276": "_attn_kernel_packed"}
    for r in rows:
        assert os.path.exists(os.path.join(REPO, r["source"])), r["source"]
        path, line = r["replaces"].split(":")
        with open(os.path.join(REPO, path)) as f:
            assert f.read().splitlines()[int(line) - 1].startswith(f"def {bodies[line]}("), r["name"]
        assert set(r) >= {"route", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


def test_kernels_line_lists_the_long_key_entries():
    """``long_key_entries``: B1, B1p and B7 past 320 keys at Hd 80, B1 with
    the served preset's launches, each from the Hd 80 source and naming the
    Pallas body whose function it computes."""
    mod = _load()
    row = lambda err: dict(max_abs_err=err, ms=1.0, plain_ms=2.0, bound_ms=0.1, bound_by="operations", library_ms=0.5,
                           shape="s", ragged_max_abs_err=err / 2)
    long = {"kernels": {"grouped": row(0.1), "packed": row(0.2), "qkv_packed": row(0.3)}, "server": {"launches": 62}}
    got = {r["name"]: (r["launches"], r["max_abs_err"], os.path.basename(r["source"]), r["replaces"])
           for r in mod.long_key_entries(long)}
    assert got == {
        "fused_attention_long_hd80": (62, 0.1, "attention_fwd_hd80.cu", "image_search_tpu/ops/attention.py:665"),
        "fused_attention_packed_long_hd80": (0, 0.2, "attention_fwd_hd80.cu", "image_search_tpu/ops/attention.py:29"),
        "fused_attention_qkv_packed_long_hd80": (0, 0.3, "attention_fwd_hd80.cu",
                                                 "image_search_tpu/ops/attention.py:276"),
    }


def test_long_key_launches_are_counted_and_reset(monkeypatch):
    """A launch past 320 keys counts in ``long_launches`` beside
    ``launches``; the smoke's reset clears both."""
    from image_search_tpu_torch.ops import attention

    mod = _load()
    fn = attention.fused_attention
    for name, value in (("launches", 0), ("launches_by_hd", {}), ("long_launches", 0), ("long_launches_by_hd", {})):
        monkeypatch.setattr(fn, name, value)
    attention._count(fn, 80, 730)
    attention._count(fn, 80, 320)
    assert (fn.launches, fn.long_launches, fn.long_launches_by_hd) == (2, 1, {80: 1})
    mod._reset_counts()
    assert (fn.launches, fn.long_launches, fn.long_launches_by_hd) == (0, 0, {})


def test_ptxas_lines_of_the_long_key_kernel_are_read(tmp_path):
    log = tmp_path / "nvcc.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN8attn_fwd20attn_fwd_long_kernelILi80ELb1EEEvPK13__nv_bfloat16' "
        "for 'sm_90a'\n"
        "    8 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN8attn_fwd15attn_fwd_kernelILi80ELb0ELi17EEEv' for 'sm_90a'\n"
        "ptxas info    : Used 255 registers\n")
    assert _load().ptxas_attention_long(log) == [
        {"Hd": 80, "norm_p": True, "spill_stores": 8, "spill_loads": 16, "registers": 128}]


def test_b5_launches_per_train_step_follow_the_towers():
    """B5 runs once in every layer's attention core but each tower's
    CLS/EOS-only last one, and in every layer under remat: by head dim, the
    vision tower's and the text tower's (bigG: 48 layers at 104, 32 at 64)."""
    from image_search_tpu_torch.config import get_config

    mod = _load()
    assert mod._b5_per_step(get_config("openclip-vit-bigG-14"), False) == {104: 47, 64: 31}
    assert mod._b5_per_step(get_config("openclip-vit-bigG-14"), True) == {104: 48, 64: 32}
    assert mod._b5_per_step(get_config("openclip-vit-H-14"), False) == {80: 31, 64: 23}
    assert mod._b5_per_step(get_config("clip-vit-large-patch14"), False) == {64: 23 + 11}


def test_ladder_training_and_the_gate_run_after_the_training_phases():
    import ast

    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    phases = [n.func.id for n in ast.walk(main)
              if isinstance(n, ast.Call) and getattr(n.func, "id", "").startswith("phase_")]
    assert phases[-3:] == ["phase_train_profile", "phase_train_ladder", "phase_learned_retrieval"]
    mod = _load()
    assert mod.GATE_SEEDS == (0, 1, 2) and mod.LADDER_TRAIN_STEPS >= 3


def test_append_transform_is_counted_and_on_the_kernels_line():
    """R1 (``normalize_rows_into``) is among the counted kernels, read and
    reset with the others, and its entry of the ``kernels`` line names its
    source, replaces no Pallas kernel and takes the restore segment's int8
    timing."""
    import ast

    from image_search_tpu_torch.ops.row_quant import normalize_rows_into

    mod = _load()
    assert normalize_rows_into in mod._kernel_counts()
    row = dict(max_abs_err=0.0, ms=1.0, plain_ms=2.0, bound_ms=0.5, bound_by="bytes", library_ms=None, shape="s")
    kern = {("row_quant", n, fmt): dict(row, ms=float(n)) for n in mod.ROW_QUANT_ROWS
            for fmt in (torch.int8, torch.bfloat16, torch.float32)}
    entry = mod.row_quant_entry(7, kern)
    assert entry["name"] == "normalize_rows_into" and entry["replaces"] is None and entry["launches"] == 7
    assert entry["ms"] == float(mod.ROW_QUANT_ROWS[-1]) and mod.ROW_QUANT_ROWS == (4096, 131_072)
    assert os.path.exists(os.path.join(REPO, entry["source"]))
    with open(SCRIPT) as f:
        main = next(n for n in ast.parse(f.read()).body if isinstance(n, ast.FunctionDef) and n.name == "main")
    assert "row_quant_entry(" in ast.unparse(main)
