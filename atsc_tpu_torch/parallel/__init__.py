"""Multi-device parallelism: channel sharding (the DP analog), field
time-block sharding with O(1)-state exchange (the SP/CP analog), and
overlap-save halo exchange for intra-field sample sharding.

Counterpart of atsc_tpu/parallel/. A mesh is a grid of shards, each a
(process rank, torch.device) pair (mesh.py); a step runs its per-shard
body on every shard this process owns, in phases, and the exchanges
between phases are device copies inside a process and torch.distributed
point-to-point messages between processes (collectives.py). The stage ops
and hand kernels below are the sequential encoder's and receiver's,
unchanged: each shard launches them on its own slice of the fields and
channels.
"""
