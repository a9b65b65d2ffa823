"""Host ms a field of the span around the copy of the encoder's output to
host memory (`.cpu().numpy()`), after the encode has been synchronized."""


def read(r):
    spans = r.host_s.get("sink_copy", [])
    return 1e3 * sum(spans) / len(spans) if spans else None
