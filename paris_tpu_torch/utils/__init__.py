from .profiling import trace, annotate, ThroughputMeter
