"""Host-side utilities of the port: ``metrics`` (counters, gauges and latency
windows), a copy of the JAX package's ``utils/metrics.py``."""
