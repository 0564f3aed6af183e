"""Run one cell of BENCHMARK.json once and print its result as the last
line of standard output:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero with no result where there is no CUDA device (or fewer
than the cell asks for), or where the process loaded JAX or the JAX
package.
"""

import os
import sys

# load from one process with few threads: the host's BLAS and torch's CPU
# pool run one thread each (set before numpy and torch load)
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
