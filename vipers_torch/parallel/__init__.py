"""Multi-process data parallelism (port of ``vipers/parallel``'s data-parallel
half): one process a card, ``torch.distributed``, ``parallel.mesh``."""
