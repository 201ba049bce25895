"""The benchmark's command: one run of one cell on the card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the result as one JSON line, last on standard output, and each
compared number beside its limit, last on standard error. Exits non-zero,
printing no result, without a CUDA device or with fewer than the cell's
cards.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
# the checkout holds every compiler cache a library of the run may keep
for _var, _dir in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(_ROOT, ".bench_cache", _dir)

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
