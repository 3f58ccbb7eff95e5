"""Flapping-filament validation: the README's tip-amplitude numbers.

Thin runner over the example's fused path (the single source of truth for
the case setup - examples/2d/flow_past_rod.py with fused=True, dynamic
in-trace rod substeps and the builder-derived no-clamp substep cap).

Expected: tip-y amplitude ~ +-0.33 L over t* in (12, 25].
"""
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "examples", "2d"))

from sopht_mpi_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

from flow_past_rod import flow_past_rod_case

t0 = time.perf_counter()
tip_time, tip_position = flow_past_rod_case(
    nondim_final_time=25.0, fused=True, window=100
)
elapsed = time.perf_counter() - t0
ys = [p[1] for t, p in zip(tip_time, tip_position) if t > 12.0]
print(
    f"wall {elapsed:.0f}s; tip-y amplitude over t*>12: "
    f"[{min(ys):+.3f}, {max(ys):+.3f}] L"
)
assert min(ys) < -0.25 and max(ys) > 0.25, "no flapping limit cycle"
print("FLAPPING OK")
