"""The result line, finding a cell's pieces by name, and no result without
a card."""

import json
import os
import shutil
import subprocess
import sys

from bench_port import harness, model_config

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _result(context=None):
    return harness.Result(
        end_to_end={"searches_per_s": 39.95, "setup_s": 120.5, "scan_img_per_s": 9.0},
        context=context or {}, correct=True, checks={"score_gap": {"value": 0.001, "limit": 0.01}},
        attempted=4000, failed=0,
        device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 123,
                "busy_s": 1.5, "window_s": 20.0},
        breakdown={"device_ops": [["k", 1.0]], "idle_gaps": [["h", 0.1]]})


def test_untraced_line_holds_the_cells_end_to_end_metrics():
    line = harness.result_line(harness.spec(), "l14-search-10m", False, _result())
    assert list(line) == KEYS + ["checks"]
    assert list(line["metrics"]) == ["searches_per_s", "setup_s"]
    assert line["metrics"]["searches_per_s"] == {"value": 39.95, "unit": "searches/s"}
    json.dumps(line)


def test_traced_line_holds_per_layer_metrics_and_the_breakdown():
    ctx = {"before": {"counters": {"searches": 10, "text_embed_cache_hits": 1}, "latencies": {"index_search": {"count": 2}}},
           "after": {"counters": {"searches": 110, "text_embed_cache_hits": 61}, "latencies": {"index_search": {"count": 7}}},
           "trace": {"busy_s": 5.0, "window_s": 20.0, "by_class": {"B2": 0.5}}, "calls": [], "b2_calls": [(20, 1000, 768, False)],
           "model": model_config.model(model_config.load("clip-vit-l14")), "corpus_rows": 10_000_000,
           "latency_ms": {"p50": 41.5, "p95": 88.25}}
    line = harness.result_line(harness.spec(), "l14-search-10m", True, _result(ctx))
    assert list(line) == KEYS + ["breakdown", "checks"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert got["search.batch_mean"] == 20.0 and got["search.text_cache_hit_pct"] == 60.0
    assert got["search.device_idle_pct"] == 75.0
    assert got["search.p50_ms"] == 41.5 and got["search.p95_ms"] == 88.25
    assert "search.mfu_pct" not in got  # no span recorded: the reader returns nothing
    assert 0 < got["search.b2_roofline"] < 100


def test_every_declared_metric_has_a_reader_and_every_cell_its_files():
    bench = harness.spec()
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for w in bench["workloads"]:
        model_config.model(model_config.load(w["config"]))
        harness.driver(harness.traffic(w["traffic"])["kind"])


def test_new_pieces_are_found_by_name(tmp_path, monkeypatch):
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(harness.HERE, d), tmp_path / d)
    cfg = model_config.load("clip-vit-l14") | {"name": "new-model"}
    (tmp_path / "configs" / "new-model.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "new-mix.json").write_text(json.dumps(harness.traffic("search-10m") | {"rate_per_s": 7}))
    (tmp_path / "metrics" / "new.metric.py").write_text("def read(ctx):\n    return ctx['x'] * 2\n")
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    monkeypatch.setattr(model_config, "HERE", str(tmp_path))
    assert model_config.load("new-model")["name"] == "new-model"
    assert harness.traffic("new-mix")["rate_per_s"] == 7
    bench = harness.spec()
    bench["workloads"].append({"name": "new-cell", "config": "new-model", "traffic": "new-mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new.metric", "unit": "%", "better": "higher", "source": "program_counter",
                               "layer": "engine", "moves": "setup_s", "workloads": ["new-cell"]})
    line = harness.result_line(bench, "new-cell", True, _result({"x": 21.0}))
    assert line["metrics"] == {"new.metric": {"value": 42.0, "unit": "%"}}


def test_run_without_a_card_prints_nothing_and_fails():
    root = os.path.dirname(harness.HERE)
    out = subprocess.run([sys.executable, os.path.join(root, "bench_port", "run.py"), "--workload", "l14-search-10m",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=root,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_host_line_reads_what_the_host_offers():
    full = {"cpu_total": 1000, "cpu_steal": 10, "available_gib": 60.5, "cached_gib": 2.5}
    line = harness.host_line(full, dict(full, cpu_total=2000, cpu_steal=60))
    assert line.startswith("host: CPU steal 5.0 % over the run;") and "60.5 GiB available" in line
    assert harness.host_line({"cpu_total": 1, "cpu_steal": 0}, {}) == "host: not read"
    assert harness.host_line({}, {}) == "host: not read"
    assert harness.host_line({"available_gib": 1.0, "cached_gib": 0.5}, {}).startswith("host: at the start 1.0 GiB")
    assert set(harness.host_state()) <= set(full)


def test_search_rate_counts_the_windows_answers_up_to_the_last():
    from bench_port.drivers import search

    reqs = [{"at": -0.5, "window": False}] + [{"at": float(t), "window": True} for t in range(4)]
    rows = [[-0.5, -0.5, 0.2, 200], [0, 0, 0.1, 200], [1, 1, 1.2, 200], [2, 2, 2.5, 200], [3, 3, 4.0, 200]]
    assert search.rate(reqs, rows) == 4 / 4.0  # a backlog past the window counts its time
    rows[4] = [3, 3, 3.1, 500]  # a failed request is no search done
    assert search.rate(reqs, rows) == 3 / 2.5
    assert search.rate(reqs, [None] * 5) == 0.0


def test_jax_modules_compares_whole_top_level_names(monkeypatch):
    import types

    for name in ("image_search_tpu_torch.fake", "image_search_tpu.index", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.jax_modules()
    assert {"flax", "image_search_tpu"} <= set(found) and "image_search_tpu_torch" not in found
