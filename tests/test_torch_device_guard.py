"""The tap-loading kernel wrappers of the PyTorch port make the tensor's
card current before anything reaches the kernel library: offset_fir_fused
and eq_fir_fused load their taps on first use (atsc_offset_fir_set_taps,
atsc_eq_fir_set_taps), and that load must run inside
torch.cuda.device(dev), or a first launch on cuda:k would load the taps
with another card current. Shown on the CPU with a fake kernel library
that records its calls, a recording stand-in for torch.cuda.device, and
inputs that report cuda:1 (the C entry points, which also save and
restore the caller's device, run only on a card; chip_smoke.py checks
there that torch.cuda.current_device() is unchanged after each wrapper's
first launch)."""

import os
import re
import types

import pytest
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops.cuda import _build
from atsc_tpu_torch.ops.cuda import eq_fir as teq
from atsc_tpu_torch.ops.cuda import offset_fir as tfir

CARD = torch.device("cuda", 1)


class _OnCard:
    """A CPU tensor that reports a CUDA device: all a wrapper reads of an
    input before the launch (dtype, shape, contiguity, data_ptr)."""

    def __init__(self, t: torch.Tensor):
        self._t = t
        self.device = CARD

    def __getattr__(self, name):
        return getattr(self._t, name)


class _Entry:
    """A C entry point of the fake library: records (name, device) and
    returns 0 (cudaSuccess)."""

    def __init__(self, name: str, events: list):
        self.name, self.events = name, events

    def __call__(self, device, *args):
        self.events.append(("call", self.name, device))
        return 0


class _FakeLib:
    def __init__(self, events: list):
        self._events = events

    def __getattr__(self, name):
        entry = _Entry(name, self._events)
        setattr(self, name, entry)
        return entry


class _Guard:
    """Stand-in for torch.cuda.device(dev): records entry and exit."""

    def __init__(self, dev, events: list):
        self.dev, self.events = torch.device(dev), events

    def __enter__(self):
        self.events.append(("enter", self.dev.index))

    def __exit__(self, *exc):
        self.events.append(("exit", self.dev.index))
        return False


def _torch_proxy(events: list):
    """The module's `torch`, with a recording torch.cuda and an empty()
    that allocates on the CPU."""
    cuda = types.SimpleNamespace(
        device=lambda dev: _Guard(dev, events),
        current_stream=lambda dev: types.SimpleNamespace(cuda_stream=0))

    class Proxy:
        def __getattr__(self, name):
            return getattr(torch, name)

    proxy = Proxy()
    proxy.cuda = cuda
    proxy.empty = lambda *a, device=None, **k: torch.empty(*a, **k)
    return proxy


@pytest.fixture
def recorded(monkeypatch):
    """(events, install(module)): the module's kernel library and torch.cuda
    replaced by recording fakes, its caches cleared before and after."""
    events: list = []
    lib = _FakeLib(events)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    cached = []

    def install(module):
        monkeypatch.setattr(module, "torch", _torch_proxy(events))
        monkeypatch.setattr(module, "LAUNCHES", module.LAUNCHES)
        for fn in ("_kernel_lib", "_tier"):
            if hasattr(module, fn):
                getattr(module, fn).cache_clear()
                cached.append(getattr(module, fn))

    yield events, install
    for fn in cached:
        fn.cache_clear()


def _inside_guard(events: list, loads: str, launch: str) -> None:
    """The first call: enter, the tap load, the launch, exit, all on
    cuda:1; the second: enter, the launch, exit (the taps stay loaded)."""
    assert events[:4] == [("enter", 1), ("call", loads, 1), ("call", launch, 1),
                          ("exit", 1)]
    assert events[4:] == [("enter", 1), ("call", launch, 1), ("exit", 1)]


def test_offset_fir_loads_its_taps_inside_the_device_guard(recorded, monkeypatch):
    events, install = recorded
    install(tfir)
    monkeypatch.setattr(tfir, "const", lambda make, dev: torch.zeros(4))
    field = _OnCard(torch.zeros((1, P.PADDED_SYMBOLS), dtype=torch.int8))
    phasor = _OnCard(torch.tensor([[1.0, 0.0]], dtype=torch.float32))
    for _ in range(2):
        tfir.offset_fir_fused(field, phasor)
    _inside_guard(events, "atsc_offset_fir_set_taps", "atsc_offset_fir")
    assert tfir.LAUNCHES >= 2


@pytest.mark.parametrize("eq_k,exact", [(128, False), (256, True)])
def test_eq_fir_loads_its_taps_inside_the_device_guard(recorded, eq_k, exact):
    events, install = recorded
    install(teq)
    win = _OnCard(torch.zeros((1, 2, teq.WIN_LEN), dtype=torch.float32))
    osc = _OnCard(torch.zeros((2, teq.WIN_LEN), dtype=torch.float32))
    for _ in range(2):
        teq.eq_fir_fused(win, osc, eq_k=eq_k, exact=exact, soft=True)
    _inside_guard(events, "atsc_eq_fir_set_taps", "atsc_eq_fir")


def test_c_entry_points_restore_the_callers_device():
    """Every C entry point that makes its device current does so through
    DeviceGuard (csrc/device_guard.cuh), which saves the caller's device
    and restores it on every return path; none calls cudaSetDevice
    itself."""
    csrc = _build.CSRC
    entries = 0
    for name in sorted(os.listdir(csrc)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(csrc, name)) as fh:
            text = fh.read()
        body = text[text.index('extern "C" {'):]
        funcs = re.findall(r"\nint (atsc_\w+)\(int device,", body)
        guards = re.findall(r"const DeviceGuard guard\(device\);", body)
        assert "cudaSetDevice" not in text, name
        assert len(funcs) == len(guards) and '#include "device_guard.cuh"' in text, name
        entries += len(funcs)
    with open(os.path.join(csrc, "device_guard.cuh")) as fh:
        guard = fh.read()
    assert "cudaGetDevice(&prev_)" in guard and "cudaSetDevice(prev_)" in guard
    assert entries == 15   # 11, and the 4 chunked Viterbi entry points
