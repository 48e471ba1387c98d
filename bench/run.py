"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; see ``bench/README.md``."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the script's own folder would shadow top-level names with its subfolders
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
# the program under test, and the benchmark's own package
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
# the CUDA JIT cache at a fixed place inside the checkout (the
# port's kernels build into build/kernels/ there on their own)
os.environ.setdefault("CUDA_CACHE_PATH",
                      os.path.join(ROOT, "build", "bench", "cuda-cache"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("OMP_NUM_THREADS", "4")

if __name__ == "__main__":
    from bench.harness.main import main

    sys.exit(main(t_start=T_START))
