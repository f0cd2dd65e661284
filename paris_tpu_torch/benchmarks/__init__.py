"""Micro-benchmarks of the port, run on the card (``python -m
paris_tpu_torch.benchmarks.<name>``): the counterparts of the
repository's ``benchmarks/`` scripts whose kernels are Pallas kernels."""
