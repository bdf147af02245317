"""The benchmark of the PyTorch/CUDA port (``mamdr_tpu_torch``) on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout; see ``harness.py``. Nothing here imports JAX or
the JAX package, and ``reference/`` imports nothing of the port.
"""
