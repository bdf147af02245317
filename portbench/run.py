"""Run one cell of the port's benchmark on the card this machine holds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (see harness.py).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's dispatch is what the cells time
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[0] = ROOT  # the checkout, not this folder

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
