"""Run one cell of the benchmark on the card and print its result line.

    python3 benchmark/run.py --workload tracker-nav.pool1.n16384 --seed 1 \
        --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` and ``device`` (and
with ``--trace 1`` ``breakdown``), and ``checks`` last: each number that
decides ``correct`` beside its limit, which the last lines of standard
error repeat. Exits non-zero, printing no result, without a CUDA card or
with fewer cards than the cell asks for. ``benchmark/README.md`` says how
the files are laid out.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this directory, is where imports start
sys.path[0] = ROOT
# build and kernel caches at fixed paths inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, os.path.join(ROOT, ".bench_cache", _sub))


if __name__ == "__main__":
    from benchmark import harness
    sys.exit(harness.main(t_start=T_START))
