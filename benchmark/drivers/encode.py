"""The transmitter's traffic: a ring of seeded TS fields in host memory,
one field of every channel at a time handed to `Encoder.encode`, one field
in flight (closed loop), its output brought to host memory: the cs8 wire
lanes as the CLI's sink takes them (`.cpu().numpy()`), or, with `mux`, the
band that `FdmMuxer.push` returns on the host.

Traffic keys: ring_fields, out_format, wire, mux, warmup_fields,
trace_fields, sample_fields, limits.

Checked: the answers of a seeded sample of the window's fields against the plain reference encoder (and multiplexer), which
replays the whole TS sequence from field 0.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import Refused, Sampler
from reference import mux as M
from reference import tables as T
from reference.encoder import RefEncoder, modulate, plan, quantize_cs8


def ts_fields(ctx, n: int) -> torch.Tensor:
    """(n, B, 58656) uint8 seeded TS on the device: random bytes, 0x47
    every 188."""
    g = torch.Generator(ctx.device).manual_seed(ctx.seed)
    ts = torch.randint(0, 256, (n, ctx.batch, T.FIELD_TS_BYTES), generator=g,
                       dtype=torch.uint8, device=ctx.device)
    ts[:, :, ::T.MPEG2_BYTES] = 0x47
    return ts


class State:
    pass


def inputs(ctx) -> State:
    st = State()
    tr = ctx.traffic
    if (tr["out_format"], bool(tr.get("mux"))) not in (("cs8", False), ("cf32", True)):
        raise Refused(f"encode traffic {tr['out_format']!r} mux={tr.get('mux')} is not "
                      "checked by this driver (cs8, or cf32 into the mux)")
    ring = ts_fields(ctx, int(tr["ring_fields"]))
    st.ring = [np.ascontiguousarray(f) for f in ring.cpu().numpy()]
    del ring
    st.sampler = Sampler(int(tr["sample_fields"]), ctx.seed)
    return st


def _program(ctx):
    from atsc_tpu_torch.models.encoder import Encoder
    from atsc_tpu_torch.ops.mux import FdmMuxer

    tr = ctx.traffic
    enc = Encoder(batch=ctx.batch, out_format=tr["out_format"], wire=bool(tr.get("wire")),
                  device=ctx.device)
    return enc, FdmMuxer(ctx.batch, device=ctx.device) if tr.get("mux") else None


def _field(ctx, enc, mux, ts):
    """One field through the program; its answer on the host."""
    with ctx.span("encode"):
        iq = enc.encode(ts)
    if mux is not None:
        with ctx.span("mux"):
            return mux.push(iq[:, :, :T.N])
    if ctx.trace:   # the copy's span holds the copy alone: `.cpu()` waits here all the same
        ctx.sync()
    with ctx.span("sink_copy"):
        return iq.cpu().numpy()


def setup(ctx) -> State:
    st = inputs(ctx)
    ctx.mark("TS ring in host memory")
    enc, mux = _program(ctx)
    ctx.mark("program built")
    for i in range(int(ctx.traffic["warmup_fields"])):   # every shape the window uses
        _field(ctx, enc, mux, st.ring[i % len(st.ring)])
    ctx.sync()
    ctx.mark("warmed up")
    st.enc, st.mux = _program(ctx)                      # the window starts cold, at field 0
    return st


def step(ctx, st: State, i: int) -> None:
    out = _field(ctx, st.enc, st.mux, st.ring[i % len(st.ring)])
    st.sampler.offer(i, lambda: out)


def counts(ctx, st, window) -> tuple[int, int]:
    return ctx.batch * window.fields, 0


def rates(ctx, st, window) -> dict:
    return {"tx_channels": ctx.batch * window.fields / window.seconds_used / T.FIELD_RATE}


def shape(ctx) -> dict:
    tr = ctx.traffic
    return {"batch": ctx.batch, "out_format": tr["out_format"], "wire": bool(tr.get("wire"))}


def release(ctx, st: State) -> None:
    st.enc = st.mux = None


def _codes(answer) -> torch.Tensor:
    """The program's cs8 answer -> (B, 2, N) int8 codes (wire lanes are
    little-endian (I, Q) byte pairs)."""
    a = np.ascontiguousarray(answer)
    if a.ndim == 2:
        pairs = a.view(np.int8).reshape(a.shape[0], -1, 2)[:, :T.N]
        return torch.from_numpy(np.ascontiguousarray(pairs)).permute(0, 2, 1)
    return torch.from_numpy(a[:, :, :T.N])


def replay(ctx, st: State, keys, precision: str = "f64"):
    """The reference's answers for the fields `keys`, replaying the TS from
    field 0: (k, codes (B, 2, N) int8) for cs8, (k, band (2, m) float64)
    with mux; operands rounded to `precision` (the control)."""
    keys = sorted(keys)
    mux = bool(ctx.traffic.get("mux"))
    modes = plan(keys, 1 if mux else 0)
    ref = RefEncoder(ctx.batch, ctx.device)
    ring = [torch.from_numpy(f).to(ctx.device) for f in st.ring]
    iq, out = {}, []
    for k in range(keys[-1] + 1):
        field = ref.step(ring[k % len(ring)], modes.get(k, "skip"))
        if k not in keys and not (mux and k + 1 in keys):
            continue
        x = modulate(field, k, precision)
        if not mux:
            out.append((k, quantize_cs8(x)))
            continue
        iq[k] = x
        if k in keys:
            prev = iq.get(k - 1, torch.zeros_like(x))
            stream = torch.cat([prev, x], dim=-1)
            out.append((k, M.band(stream, (k - 1) * T.N, M.blocks_after(k * T.N),
                                  M.blocks_after((k + 1) * T.N), precision)))
        iq.pop(k - 1, None)
    return out


def numbers(ctx, st: State, answers: list) -> list[tuple[str, float, float]]:
    """Each number compared, with its limit, for answers [(k, answer)]."""
    lim = ctx.traffic["limits"]
    ref = dict(replay(ctx, st, [k for k, _ in answers]))
    if ctx.traffic.get("mux"):
        rel_rms = rel_max = 0.0
        for k, band in answers:
            r = ref[k]
            got = (band if isinstance(band, torch.Tensor) else torch.from_numpy(np.asarray(band)))
            got = got.to(ctx.device, torch.float64)
            if got.shape != r.shape:
                return [("band_rel_rms", float("inf"), lim["band_rel_rms"]),
                        ("band_rel_max", float("inf"), lim["band_rel_max"])]
            rms = float(r.pow(2).mean().sqrt())
            rel_rms = max(rel_rms, float((got - r).pow(2).mean().sqrt()) / rms)
            rel_max = max(rel_max, float((got - r).abs().max()) / rms)
        return [("band_rel_rms", rel_rms, lim["band_rel_rms"]),
                ("band_rel_max", rel_max, lim["band_rel_max"])]
    off = total = 0
    worst = 0
    for k, answer in answers:
        got = answer if isinstance(answer, torch.Tensor) else _codes(answer)
        got = got.to(ctx.device)
        if got.shape != ref[k].shape:
            return [("wire_max_lsb", float("inf"), lim["wire_max_lsb"]),
                    ("wire_off_share", float("inf"), lim["wire_off_share"])]
        d = (got.to(torch.int32) - ref[k].to(torch.int32)).abs()
        off += int((d > 0).sum())
        total += d.numel()
        worst = max(worst, int(d.max()))
    return [("wire_max_lsb", float(worst), lim["wire_max_lsb"]),
            ("wire_off_share", off / total, lim["wire_off_share"])]


def check(ctx, st: State) -> list[tuple[str, float, float]]:
    return numbers(ctx, st, st.sampler.items())


def control(ctx, st: State, keys, precision: str):
    """The reference at `precision` in the program's place."""
    return replay(ctx, st, keys, precision)
