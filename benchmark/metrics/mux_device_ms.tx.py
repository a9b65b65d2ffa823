"""Device ms a field of the kernels launched inside `FdmMuxer.push`."""


def read(r):
    if r.trace is None or not r.trace.fields or not r.trace.in_window():
        return None
    return 1e3 * r.trace.device_s("mux") / r.trace.fields
