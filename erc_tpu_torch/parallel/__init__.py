"""Data parallelism over processes (``parallel.mesh``): the port of ``erc_tpu.parallel``."""
