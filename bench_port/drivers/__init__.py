"""One module a kind of traffic (``search``, ``scan``, ``finetune``); each
``run(cell)`` runs one cell and returns a ``harness.Result``."""
