"""Host-side (numpy) table builders — the 'precompute everything' substrate.

The port's own copy of atsc_tpu/tables/ (the JAX package is never
imported here): every table is built once on the host and copied to each
device once (ops/_const.py); runtime stages are pure vectorized ops over
them. tests/test_torch_isolation.py holds every table equal to the JAX
package's.
"""
