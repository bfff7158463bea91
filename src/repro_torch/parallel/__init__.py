"""Multi-device parallelism of the port (torch twin of ``repro.parallel``)."""
