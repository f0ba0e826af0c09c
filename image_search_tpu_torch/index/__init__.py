"""Device-resident vector index of the port, its duplicate scan and the
on-disk store (``store.py``, a copy of the JAX package's: both packages read
and write the same index directories)."""
