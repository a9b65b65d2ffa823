#!/usr/bin/env python3
"""Drive the PyTorch port's transmit main path once on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failed check exits non-zero:

1. device: name, compute capability (must be 9.0), nvidia-smi's name and
   power limit; TF32 is switched off for matmul and cuDNN.
2. build: nvcc builds csrc/offset_fir.cu from this checkout; seconds and
   ptxas' resource lines.
3. kernel: offset_fir_fused against its plain PyTorch twin on the card at
   B=4 (random symbols plus golden field 0): cf32 <= 2e-6, cs16/cs8 planar
   and wire <= 1 LSB over the valid [0, 260416).
4. golden: Encoder(batch=1, device="cuda") over the 4 golden fields: IQ
   <= 5e-6, randomize/RS/interleave bytes exact, final phasor bit-exact,
   one kernel launch per field.
5. full size: Encoder(batch=384) for cf32, cs16 planar and cs8 wire: 3
   warm + 10 timed fields (CUDA events), channel 0 of the first timed
   field against the port's CPU path (<= 5e-6 / <= 1 LSB); then the
   kernel against the plain twin at B=384 cf32, both timed.
6. cli: atsc_tpu_torch.cli.main on a 12-field TS file, 4 channels, cs8.

Then the kernels line, and last {"ok": true, "device": {...}}. Without a
CUDA device, or without the package beside this script, it fails before
printing any result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
B_FULL = 384        # channels of a headend batch: the middle of bench.py's grid
WARM, TIMED = 3, 10


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "atsc_tpu_torch")):
        fail(f"no atsc_tpu_torch package beside {os.path.basename(__file__)}")
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")

    from atsc_tpu import params as P
    from atsc_tpu.tables.oscillator import phasor_for_field
    from atsc_tpu_torch import cli
    from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex
    from atsc_tpu_torch.ops import (
        interleave_field_enc_major,
        randomize_field,
        rs_encode_field,
    )
    from atsc_tpu_torch.ops.cuda import _build
    from atsc_tpu_torch.ops.cuda import offset_fir as fir
    from atsc_tpu_torch.ops.quantize import unpack_wire

    n_valid = P.SYMBOLS_PER_FIELD
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    golden = np.load(os.path.join(REPO, "tests", "golden", "golden.npz"))

    # -- 1. device -----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=name, capability=list(cap),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    check(cap == (9, 0), f"compute capability {cap}, the kernel is built for sm_90a")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build("offset_fir")
    fir._kernel_lib(0)
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=round(built.seconds, 3), reused=built.seconds == 0.0,
         library=os.path.relpath(built.path, REPO), ptxas=ptxas)

    # -- 3. kernel against plain on the card ----------------------------------
    def code_err(got: torch.Tensor, want: torch.Tensor, fmt: str, wire: bool) -> int:
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if wire:
            g, w = unpack_wire(g, fmt), unpack_wire(w, fmt)
        return int(np.abs(g[..., :n_valid].astype(np.int32)
                          - w[..., :n_valid].astype(np.int32)).max())

    rng = np.random.default_rng(2024)
    sym = rng.integers(0, 8, size=(4, P.PADDED_SYMBOLS), dtype=np.int8)
    levels0 = golden["sync"][0].real.astype(np.float32)
    sym[0] = np.rint((levels0 - P.PILOT_OFFSET + 7.0) / 2.0).astype(np.int8)
    sym[0, P.PADDED_SYMBOLS - P.RESERVED_SYMBOLS:] = 0
    ph = np.array([[np.float32(z.real), np.float32(z.imag)]
                   for z in map(phasor_for_field, (0, 1, 7, 4096))], np.float32)
    field = torch.tensor(sym, device=dev)
    phasor = torch.tensor(ph, device=dev)
    errs = {}
    for fmt, wire in (("cf32", False), ("cs16", False), ("cs8", False),
                      ("cs16", True), ("cs8", True)):
        got = fir.offset_fir_fused(field, phasor, out_format=fmt, wire=wire)
        want = fir.offset_fir_plain(field, phasor, out_format=fmt, wire=wire)
        torch.cuda.synchronize()
        shape, dtype = fir.output_spec(4, fmt, wire)
        check(tuple(got.shape) == shape and got.dtype == dtype,
              f"{fmt} wire={wire}: kernel output {tuple(got.shape)} {got.dtype}")
        key = fmt + ("_wire" if wire else "")
        if fmt == "cf32":
            errs[key] = float((got[..., :n_valid] - want[..., :n_valid]).abs().max())
            check(errs[key] <= 2e-6, f"cf32 kernel vs plain {errs[key]} > 2e-6")
        else:
            errs[key] = code_err(got, want, fmt, wire)
            check(errs[key] <= 1, f"{key} kernel vs plain {errs[key]} LSB > 1")
    emit("kernel", batch=4, max_abs_err_cf32=errs["cf32"],
         max_lsb_err={k: v for k, v in errs.items() if k != "cf32"},
         tolerance={"cf32": 2e-6, "codes_lsb": 1})

    # -- 4. golden through the encoder on the card ----------------------------
    prev = torch.zeros((1, P.DATA_PER_FIELD), dtype=torch.uint8, device=dev)
    for f in range(4):
        rand = randomize_field(torch.tensor(golden["input"][f][None], device=dev))
        rs = rs_encode_field(rand).reshape(1, -1)
        il = interleave_field_enc_major(rs, prev)
        il_golden = golden["il"][f].reshape(
            P.TRELLIS_ROUNDS, P.TRELLIS_ENCODERS, P.TRELLIS_INPUT_BYTES
        ).transpose(1, 0, 2).reshape(P.TRELLIS_ENCODERS, -1)
        check(np.array_equal(rand.cpu().numpy().reshape(-1), golden["rand"][f]),
              f"randomize bytes differ from golden, field {f}")
        check(np.array_equal(rs.cpu().numpy()[0], golden["rs"][f]),
              f"RS bytes differ from golden, field {f}")
        check(np.array_equal(il.cpu().numpy()[0], il_golden),
              f"interleave bytes differ from golden, field {f}")
        prev = rs
    fir.LAUNCHES = 0
    enc = Encoder(batch=1, device=dev)
    iq_err = 0.0
    for f in range(4):
        iq = enc.encode(golden["input"][f][None])
        iq_err = max(iq_err, float(np.abs(iq_to_complex(iq)[0] - golden["iq"][f]).max()))
    launches_golden = fir.LAUNCHES
    z4 = phasor_for_field(4)
    got_ph = enc.state.phasor.cpu().numpy()[0]
    phasor_exact = bool(got_ph[0] == np.float32(z4.real)
                        and got_ph[1] == np.float32(z4.imag))
    emit("golden", fields=4, max_abs_err_iq=iq_err, tolerance=5e-6,
         stage_bytes_exact=True, phasor_bit_exact=phasor_exact,
         launches=launches_golden)
    check(iq_err <= 5e-6, f"golden IQ error {iq_err} > 5e-6")
    check(phasor_exact, f"phasor after 4 fields {got_ph} != phasor_for_field(4)")
    check(launches_golden == 4, f"{launches_golden} kernel launches for 4 fields")

    # -- 5. full size --------------------------------------------------------
    n_fields = WARM + TIMED
    ts_np = rng.integers(0, 256, size=(n_fields, B_FULL, P.FIELD_TS_BYTES),
                         dtype=np.uint8)
    ts_np[..., ::P.MPEG2_BYTES] = 0x47
    ts_dev = torch.tensor(ts_np, device=dev)
    full = {}
    fir.LAUNCHES = 0
    for fmt, wire in (("cf32", False), ("cs16", False), ("cs8", True)):
        key = fmt + ("_wire" if wire else "")
        enc = Encoder(batch=B_FULL, out_format=fmt, wire=wire, device=dev)
        for f in range(WARM):
            enc.encode(ts_dev[f])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        launches0 = fir.LAUNCHES
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        first = enc.encode(ts_dev[WARM])
        for f in range(WARM + 1, n_fields):
            enc.encode(ts_dev[f])
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / TIMED
        peak = torch.cuda.max_memory_allocated(dev)
        dlaunch = fir.LAUNCHES - launches0
        got0 = first[0].cpu().numpy()
        del first, enc
        ref = Encoder(batch=1, out_format=fmt, wire=wire, device="cpu")
        for f in range(WARM + 1):
            want0 = ref.encode(ts_np[f, :1])[0].numpy()
        if fmt == "cf32":
            err = float(np.abs(got0[..., :n_valid] - want0[..., :n_valid]).max())
            check(err <= 5e-6, f"B={B_FULL} cf32 channel 0 vs CPU: {err} > 5e-6")
        else:
            g, w = (unpack_wire(got0, fmt), unpack_wire(want0, fmt)) if wire else (got0, want0)
            err = int(np.abs(g[..., :n_valid].astype(np.int32)
                             - w[..., :n_valid].astype(np.int32)).max())
            check(err <= 1, f"B={B_FULL} {key} channel 0 vs CPU: {err} LSB > 1")
        t_field = ms / 1e3
        full[key] = {
            "ms_per_field": ms,
            "samples_per_s": B_FULL * n_valid / t_field,
            "realtime_channels": B_FULL / (t_field * P.FIELD_RATE),
            "max_memory_allocated": peak,
            "launches": dlaunch,
            "err_vs_cpu": err,
        }
        emit("full_size", batch=B_FULL, format=key, timed_fields=TIMED, **full[key])
        check(dlaunch == TIMED, f"{dlaunch} kernel launches for {TIMED} fields")
    launches_main = fir.LAUNCHES
    check(launches_main == 3 * n_fields,
          f"{launches_main} kernel launches for {3 * n_fields} encoded fields")

    # the kernel against the plain twin at B=384 cf32, in turns
    sym_full = torch.randint(0, 8, (B_FULL, P.PADDED_SYMBOLS), dtype=torch.int8,
                             device=dev, generator=torch.Generator(dev).manual_seed(7))
    ph_full = phasor[torch.arange(B_FULL, device=dev) % 4].contiguous()

    def timed(fn, reps: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    run_kernel = lambda: fir.offset_fir_fused(sym_full, ph_full)  # noqa: E731
    run_plain = lambda: fir.offset_fir_plain(sym_full, ph_full)   # noqa: E731
    p1, k1, k2, p2 = timed(run_plain), timed(run_kernel), timed(run_kernel), timed(run_plain)
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    err_full = float((run_kernel()[..., :n_valid] - run_plain()[..., :n_valid]).abs().max())
    emit("kernel_vs_plain", batch=B_FULL, format="cf32", kernel_ms=[k1, k2],
         plain_ms=[p1, p2], max_abs_err=err_full)
    check(err_full <= 2e-6, f"B={B_FULL} cf32 kernel vs plain {err_full} > 2e-6")
    del sym_full

    # -- 6. the CLI, in process -----------------------------------------------
    cli_fields, cli_channels = 12, 4
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=REPO) as tmp:
        ts_path = os.path.join(tmp, "in.ts")
        out_path = os.path.join(tmp, "out.cs8")
        ts_cli = np.random.default_rng(5).integers(
            0, 256, size=(cli_fields, P.FIELD_TS_BYTES), dtype=np.uint8)
        ts_cli[:, ::P.MPEG2_BYTES] = 0x47
        ts_cli.tofile(ts_path)
        fir.LAUNCHES = 0
        err_buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err_buf):
            rc = cli.main([ts_path, "--channels", str(cli_channels), "--format",
                           "cs8", "-o", out_path, "--stats"])
        wall = time.perf_counter() - t0
        launches_cli = fir.LAUNCHES
        stats = json.loads(err_buf.getvalue().strip().splitlines()[-1])
        size = os.path.getsize(out_path)
        out = np.fromfile(out_path, dtype=np.int16, count=n_valid)  # field 0, ch 0
    want_size = cli_fields * cli_channels * n_valid * 2
    ref = Encoder(batch=1, out_format="cs8", wire=True, device="cpu")
    want = ref.encode(ts_cli[:1])[0].numpy()[:n_valid]
    cli_err = int(np.abs(unpack_wire(out, "cs8").astype(np.int32)
                         - unpack_wire(want, "cs8").astype(np.int32)).max())
    emit("cli", rc=rc, bytes=size, expected_bytes=want_size, wall_s=wall,
         launches=launches_cli, err_vs_cpu_lsb=cli_err, stats=stats)
    check(rc == 0, f"cli.main returned {rc}")
    check(size == want_size, f"CLI wrote {size} bytes, expected {want_size}")
    check(stats["fields"] == cli_fields * cli_channels and stats["ts_sync_errors"] == 0
          and stats["device"] == str(dev), f"CLI stats line {stats}")
    check(launches_cli == cli_fields, f"{launches_cli} launches for {cli_fields} CLI fields")
    check(cli_err <= 1, f"CLI output vs CPU encoder: {cli_err} LSB > 1")

    print(json.dumps({"kernels": [{
        "name": "offset_fir_fused",
        "route": "cuda",
        "source": "atsc_tpu_torch/csrc/offset_fir.cu",
        "replaces": "atsc_tpu/ops/pallas/offset_fir.py:148",
        "launches": launches_main,
        "max_abs_err": errs["cf32"],
        "max_lsb_err": {k: v for k, v in errs.items() if k != "cf32"},
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
