"""The benchmark's plain reference: ATSC A/53 Part 2 8-VSB in NumPy and plain
PyTorch, written from the standard's numerology and frozen with the benchmark.

It imports nothing of the program under test (the `atsc_tpu_torch` package)
and nothing of JAX, and takes no table, weight or state that the program
made: every table is rebuilt here. `encoder` makes the transmitted IQ,
symbols and quantized captures, `mux` the FDM multiplex of a band, and
`equalizer` the zero-forcing receive equalizer's levels. Each works in
float64 on whatever device its tensors are on, and each takes a `precision`
that rounds its operands to a lower type: that is the control of the
comparison that decides `correct`.
"""
