"""The benchmark of ``paris_tpu_torch``, the PyTorch and CUDA FDK port.

    python3 -m fdk_bench.run --workload NAME --seed N --seconds S --trace 0|1

runs one cell of ``BENCHMARK.json`` once on the card and prints its
result as the last line of standard output.  Everything that belongs to
one configuration, traffic mix or metric is a file of its own, found by
name: ``configs/<config>.json``, ``traffic/<mix>.json`` (which names its
driver, ``drivers/<driver>.py``) and ``metrics/<metric>.py``.  ``lib/``
holds the frozen yardstick (data generator, HIS writer, K1 work count and
peaks, trace reduction), ``reference/`` the plain FDK that decides
``correct``.  Nothing here imports JAX or the JAX package.
"""
