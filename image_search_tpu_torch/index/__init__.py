"""Device-resident vector index of the port; the on-disk store is shared with
the reference (``image_search_tpu/index/store.py``, loaded by path)."""
