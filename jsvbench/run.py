"""Run one cell of BENCHMARK.json once, on the CUDA card:

    python3 jsvbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output (see
:mod:`jsvbench.harness`).  Exits with an error, printing no result, when
no CUDA card is there, or when anything the run loaded is JAX or jsvx.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)
# every build and kernel cache inside the checkout, at fixed paths (the
# program's own nvcc and g++ builds go to build/jsvx_torch/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "jsvbench", sub)

from jsvbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
