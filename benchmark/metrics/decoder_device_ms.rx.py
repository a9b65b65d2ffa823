"""Device ms a field of the kernels launched inside `Decoder.decode` /
`SoftDecoder.decode` (the trellis decode, syndromes, RS correction when a
segment is dirty, derandomization)."""


def read(r):
    if r.trace is None or not r.trace.fields or not r.trace.in_window():
        return None
    return 1e3 * r.trace.device_s("decode") / r.trace.fields
