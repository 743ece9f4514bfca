"""The benchmark of the PyTorch + CUDA port: `python3 slambench/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>` (see run.py)."""
