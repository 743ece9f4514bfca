"""The benchmark harness: specs, scenes, the measured window, the trace
reduction and the correctness checks."""
