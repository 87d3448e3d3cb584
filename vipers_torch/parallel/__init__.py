"""Multi-process parallelism, one process a card (port of ``vipers/parallel``):
``mesh`` (the rendezvous, the process grid, data parallelism), ``tp``
(tensor parallelism), ``pp`` (pipeline parallelism), ``sp`` (sequence
parallelism)."""
