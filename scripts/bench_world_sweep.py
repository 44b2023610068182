"""Sweep bench.py's world count on the GPU in one process (amortizes warmup).

The throughput sweet spot can shift as kernels change the collect/learn
balance; rerun after perf work: python scripts/bench_world_sweep.py
"""

import sys
import time

sys.path.insert(0, ".")

import jax

from madrona_learn_tpu.utils.platform import compute_dtype

import bench


def run(num_worlds, timed=10):
    mgr = bench.build_manager(compute_dtype(), num_worlds)
    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    mgr = update(mgr)
    jax.device_get(mgr.metrics.metrics["Loss"].mean)
    t0 = time.perf_counter()
    for _ in range(timed):
        mgr = update(mgr)
    jax.device_get(mgr.metrics.metrics["Loss"].mean)
    dt = time.perf_counter() - t0
    rate = num_worlds * bench.STEPS_PER_UPDATE * timed / dt
    print(f"worlds={num_worlds:6d}: {rate/1e6:6.2f}M env-steps/s "
          f"({dt/timed*1e3:.1f} ms/update)", flush=True)
    return rate


def main():
    for w in (4096, 8192, 16384, 32768, 65536):
        run(w)


if __name__ == "__main__":
    main()
