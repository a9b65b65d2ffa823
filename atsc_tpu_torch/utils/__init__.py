"""Host-side utilities: throughput counters and state conversion."""
