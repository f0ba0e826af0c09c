"""Host-side utilities of the port, copies of the JAX package's own:
``metrics`` (counters, gauges and latency windows, ``utils/metrics.py``) and
``eval`` (retrieval recall@k and median rank, ``utils/eval.py``)."""
