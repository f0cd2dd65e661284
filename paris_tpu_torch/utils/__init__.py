from .profiling import trace, span, job, collected, ThroughputMeter
