"""Run one cell of the port's benchmark once.

    python3 bench_port/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  Bytecode, Triton, CUDA and extension
caches go to fixed directories under the checkout's `build/`, so only
the first run in a checkout builds and compiles.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
sys.pycache_prefix = os.path.join(BUILD, "pycache")
sys.dont_write_bytecode = False
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(BUILD, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from bench_port.harness import main
    sys.exit(main(sys.argv[1:], T0))
