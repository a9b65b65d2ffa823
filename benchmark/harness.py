"""What every cell's run shares: finding the cell, its configuration, its
traffic and its metrics by name; the guards; the closed-loop window; the
sample of answers to check; and the result line.

A cell is an entry of BENCHMARK.json's `workloads`. Its traffic is the data
file workloads/<cell>.json, whose `entry` names the module
drivers/<entry>.py that feeds the program; its configuration is the file
that BENCHMARK.json's `configs` entry names. A per-layer metric <m> is read
by metrics/<m>.py. All are found by name, so a cell, a configuration or a
metric is added as a file.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "atsc_tpu")


class Refused(Exception):
    """A run that cannot be made here: it prints no result."""


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise Refused(f"no file {os.path.relpath(path, ROOT)}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of BENCHMARK.json with its configuration, its traffic file and
    the metrics it reports, found by name."""

    def __init__(self, name: str, root: str = ROOT):
        bench_path = os.path.join(root, "BENCHMARK.json")
        if not os.path.exists(bench_path):
            raise Refused("no BENCHMARK.json at the root of the checkout")
        self.spec = load_json(bench_path)
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise Refused(f"no cell {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config = load_json(os.path.join(root, configs[self.entry["config"]]["file"]))
        self.bench = os.path.join(root, "benchmark")
        self.traffic = load_json(os.path.join(self.bench, "workloads", name + ".json"))
        if self.traffic.get("traffic") != self.entry["traffic"]:
            raise Refused(f"workloads/{name}.json is traffic {self.traffic.get('traffic')!r}, "
                          f"BENCHMARK.json says {self.entry['traffic']!r}")
        self.chips = int(self.entry["chips"])

    def metrics(self, kind: str) -> list[dict]:
        """The cell's `end_to_end` or `per_layer` metrics."""
        return [m for m in self.spec[kind] if self.name in m.get("workloads", [self.name])]

    def driver(self):
        return load_module(os.path.join(self.bench, "drivers", self.traffic["entry"] + ".py"),
                           "bench_driver_" + self.traffic["entry"])


def require_cuda(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is False: the benchmark measures the card "
                      "and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX package or the JAX
    package under port (whole names: atsc_tpu_torch is not atsc_tpu)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Sampler:
    """A uniform sample of k answers of a stream whose length is not known
    in advance (reservoir sampling from the seed). Only the kept answers
    are held, so the window frees the others as the program would."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 0x5A3])
        self.kept: dict = {}
        self.seen = 0

    def offer(self, key, make):
        """Keep `make()` under `key` if drawn; make is called only then."""
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept[key] = make()
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                del self.kept[list(self.kept)[j]]
                self.kept[key] = make()
        return key in self.kept

    def items(self) -> list:
        return sorted(self.kept.items(), key=lambda kv: kv[0])


class Window:
    """The closed loop: call `step(i)` until `seconds` have passed, one
    field in flight; each step's host-clock latency is kept."""

    def __init__(self, seconds: float | None, max_fields: int | None):
        self.seconds = seconds
        self.max_fields = max_fields
        self.latency_s: list[float] = []
        self.t0 = self.t1 = 0.0

    def run(self, step) -> None:
        self.t0 = time.perf_counter()
        i = 0
        while True:
            a = time.perf_counter()
            step(i)
            b = time.perf_counter()
            self.latency_s.append(b - a)
            i += 1
            if self.max_fields is not None and i >= self.max_fields:
                break
            if self.max_fields is None and b - self.t0 >= self.seconds:
                break
        self.t1 = time.perf_counter()

    @property
    def fields(self) -> int:
        return len(self.latency_s)

    @property
    def seconds_used(self) -> float:
        return self.t1 - self.t0

    def percentile_ms(self, q: float) -> float:
        return float(np.percentile(np.array(self.latency_s) * 1e3, q))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
