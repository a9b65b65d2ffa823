"""The harness's own rules: cells, configurations and metrics found by file
name; no result without a card; no JAX; the roofline counts."""

from __future__ import annotations

import ast
import glob
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import harness
from conftest import BENCH

ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_spec_names_and_files():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert spec["paths"] == ["benchmark"] and spec["command"] == ["python3", "benchmark/run.py"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec[group]:
            assert NAME.match(entry["name"]), entry["name"]
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"])) and len(c["source"]) <= 200
    for w in spec["workloads"]:
        assert len(w["why"]) <= 200
        cell = harness.Cell(w["name"])
        assert cell.traffic["traffic"] == w["traffic"]
        assert os.path.exists(os.path.join(BENCH, "drivers", cell.traffic["entry"] + ".py"))
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    assert all(0.01 <= m["bound"] <= 0.25 for m in spec["end_to_end"])


def test_a_new_cell_is_a_new_file(tmp_path):
    """A copy of the benchmark with one more cell, configuration and metric
    added as files (and entries): the harness finds each by name."""
    shutil.copytree(BENCH, tmp_path / "benchmark")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["configs"].append(dict(spec["configs"][0], name="pool_8",
                                file="benchmark/configs/pool_8.json"))
    cfg = json.load(open(os.path.join(BENCH, "configs", "channel_pool_384.json")))
    (tmp_path / "benchmark" / "configs" / "pool_8.json").write_text(
        json.dumps(dict(cfg, name="pool_8", channels=8)))
    spec["workloads"].append({"name": "pool8.tx", "config": "pool_8", "traffic": "tx_closed",
                              "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "extra_ms.tx", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "host I/O",
                              "moves": "tx_channels", "workloads": ["pool8.tx"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copy(os.path.join(BENCH, "workloads", "pool384.tx.json"),
                tmp_path / "benchmark" / "workloads" / "pool8.tx.json")
    (tmp_path / "benchmark" / "metrics" / "extra_ms.tx.py").write_text(
        "def read(r):\n    return 1.5\n")
    cell = harness.Cell("pool8.tx", root=str(tmp_path))
    assert cell.config["channels"] == 8 and cell.traffic["entry"] == "encode"
    assert [m["name"] for m in cell.metrics("per_layer")] == ["extra_ms.tx"]
    mod = harness.load_module(str(tmp_path / "benchmark" / "metrics" / "extra_ms.tx.py"), "x")
    assert mod.read(None) == 1.5
    with pytest.raises(harness.Refused):
        harness.Cell("no.such.cell", root=str(tmp_path))


def test_no_result_without_a_card():
    """This machine's torch has no CUDA: the run refuses, exit 2, and prints
    nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is for machines without one")
    proc = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                           "pool384.tx", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "is_available() is False" in proc.stderr


def test_no_result_outside_a_checkout(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark: no
    program to measure, a non-zero exit, no result."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "pool384.tx",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("jax", "jaxlib", "flax", "atsc_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "atsc_tpu_torch_lookalike", object())
    monkeypatch.setitem(sys.modules, "atsc_tpu_torch.models", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "atsc_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["atsc_tpu", "jax"]


def test_the_benchmark_imports_no_jax():
    """No file of the benchmark imports JAX, Flax or the JAX package (whole
    top-level names); the reference imports nothing of the program either."""
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            tops = {n.split(".", 1)[0] for n in names}
            assert not tops & set(harness.FORBIDDEN), (path, tops)
            if os.sep + "reference" + os.sep in path:
                assert "atsc_tpu_torch" not in tops, path


def _metric(name):
    return harness.load_module(os.path.join(BENCH, "metrics", name + ".py"), "m_" + name)


def test_roofline_counts_at_384():
    """The operation and byte counts against the records of the port's
    kernel table at B = 384 (bounds in ms)."""
    from peaks import BF16_FLOP_PER_S, FP32_FLOP_PER_S, bound_s

    fir = _metric("offset_fir_roofline.tx")
    nbytes, flops = fir.work(384, "cf32", False)
    assert abs(flops - 44.4e9) < 0.05e9
    assert abs(bound_s(nbytes, flops, FP32_FLOP_PER_S) * 1e3 - 0.663) < 0.001
    eq = _metric("eq_fir_roofline.rx")
    nbytes, flops = eq.work(384, 128, 4, False)          # a float32 window
    assert abs(bound_s(nbytes, flops, BF16_FLOP_PER_S) * 1e3 - 0.270) < 0.002
    acs = _metric("acs_forward_roofline.rx")
    nbytes, flops = acs.work(384)
    assert abs(nbytes - (397e6 + 99e6)) < 1.5e6
    assert abs(bound_s(nbytes, flops, FP32_FLOP_PER_S) * 1e3 - 0.148) < 0.001
    tb = _metric("traceback_roofline.rx")
    nbytes, _ = tb.work(384)
    assert abs(bound_s(nbytes, 0.0, FP32_FLOP_PER_S) * 1e3 - 0.059) < 0.001


def test_roofline_reader_is_silent_without_kernels():
    class R:
        trace = None
        shape = {"batch": 2, "out_format": "cs8", "wire": True}
    assert _metric("offset_fir_roofline.tx").read(R()) is None


def test_device_time_goes_to_the_span_that_launched_it():
    """A kernel that runs after its span closed still counts for the span
    whose host interval holds its launch (the correlation id); one whose
    launch the trace lacks counts for no span, but for the busy time."""
    from devtrace import TraceView

    def x(cat, name, ts, dur, corr=None):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {} if corr is None else {"correlation": corr}}
    view = TraceView([x("user_annotation", "bench.field", 0, 100),
                      x("user_annotation", "bench.encode", 0, 40),
                      x("user_annotation", "bench.mux", 41, 59),
                      x("cuda_runtime", "cudaLaunchKernel", 10, 1, 7),
                      x("cuda_runtime", "cudaLaunchKernel", 50, 1, 8),
                      x("kernel", "k_enc", 45, 10, 7),
                      x("kernel", "k_mux", 60, 20, 8),
                      x("kernel", "k_unlinked", 20, 5)])
    assert view.by_correlation == 2
    assert abs(view.device_s("encode") - 10e-6) < 1e-12
    assert abs(view.device_s("mux") - 20e-6) < 1e-12
    assert abs(view.busy_s() - 35e-6) < 1e-12
    assert [round(t * 1e6, 9) for t in view.kernel_times("k_mux")] == [20.0]
