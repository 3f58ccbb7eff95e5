"""Benchmark: 3D FSI step throughput on one NVIDIA GPU.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "Mcells/s", "vs_baseline": N,
     "sec_per_step": N, ..., "device_kind": ..., "power_limit_w": N}

Runs in one process and fails when JAX finds no GPU:
    BENCH_CASE=sphere|rod|multibody BENCH_GRID=256 python bench.py

Metric: million Eulerian cell-updates per second for the full fused
coupled FSI timestep (CFL dt control + penalty IBM interaction +
rotational-form Navier-Stokes step with unbounded Poisson velocity
recovery), rolled out with a single on-device ``lax.scan`` - the
north-star configuration of BASELINE.json.

The reference publishes no numbers (BASELINE.md), and its MPI stack cannot
be provisioned here (no mpi4py/FFTW/pystencils, no egress), so vs_baseline
uses a MEASURED proxy: the same fused FSI step - dense reference-shaped
IBM path, reference-faithful forcing-grid sizing (n_eq = 120 at 256^3) -
timed on the host CPU via XLA (doc/baseline_cpu_measurement.py, results
in doc/baseline_cpu_measured.json: 31.50 s/step at 256^3 on 1 core,
compile excluded), scaled by an IDEAL 64-rank speedup (generous to the
reference) -> 0.4922 s/step at 256^3. See BASELINE.md for the derivation.
"""

import json
import os
import time

GRID = int(os.environ.get("BENCH_GRID", "256"))
STEPS = int(os.environ.get("BENCH_STEPS", "10"))
# BENCH_CASE selects the workload:
#   sphere    - rigid flow-past-sphere FSI at (G, G, G)  [the north star]
#   rod       - flexible-rod FSI at the reference's own aspect (G, G/4, G)
#               (flow_past_rod_case.py:309-314: nz=nx, ny=nx/4)
#   multibody - mixed rod + rigid sphere at (G/2, G/2, G) (BASELINE cfg 5)
CASE = os.environ.get("BENCH_CASE", "sphere")


def _case_grid(case: str, g: int) -> tuple[int, int, int]:
    if case == "rod":
        return (g, max(8, g // 4), g)
    if case == "multibody":
        return (max(8, g // 2), max(8, g // 2), g)
    return (g, g, g)


def _baseline_sec_per_step() -> float | None:
    """Measured-CPU-derived 64-rank baseline for THIS case AT THE BENCHED
    GRID (see module docstring); read from the measurement artifact so the
    numbers and their provenance stay in one place. Returns None when the
    artifact has no measurement for this case+grid - vs_baseline is then
    emitted as null rather than a meaningless cross-config ratio."""
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "doc",
        "baseline_cpu_measured.json",
    )
    import sys

    fallback_256 = 0.4922  # the recorded sphere 256^3 measurement, inlined
    try:
        with open(path) as f:
            data = json.load(f)
        if CASE == "sphere":
            per_grid = data["measured_sec_per_step_1core"]
        else:
            per_grid = data.get("cases", {}).get(CASE, {}).get(
                "measured_sec_per_step_1core", {}
            )
        ranks = float(data["assumed_ranks"])
        if str(GRID) not in per_grid:
            print(
                f"WARNING: no measured CPU baseline for case {CASE} at "
                f"grid {GRID} (have {sorted(per_grid)}); emitting "
                "vs_baseline=null",
                file=sys.stderr,
            )
            return None
        return float(per_grid[str(GRID)]) / ranks
    except (OSError, KeyError, ValueError, TypeError) as e:
        # keep stdout as the single JSON line; warn loudly on stderr so a
        # missing/corrupt artifact cannot silently skew vs_baseline
        print(
            f"WARNING: baseline artifact unreadable ({e!r}); using the "
            f"inlined recorded 256^3 measurement {fallback_256} s/step",
            file=sys.stderr,
        )
        return fallback_256 if GRID == 256 and CASE == "sphere" else None


BASELINE_SEC_PER_STEP = _baseline_sec_per_step()


def main():
    import jax
    import numpy as np

    from sopht_mpi_tpu.utils.compile_cache import configure_compile_cache
    from sopht_mpi_tpu.utils.device import (
        nvidia_smi_lines,
        parse_nvidia_smi_line,
        require_gpu,
    )

    devices = require_gpu(jax.devices())
    configure_compile_cache()

    from __graft_entry__ import (
        _build_fsi_case,
        _build_multibody_bench_case,
        _build_rod_bench_case,
    )
    from sopht_mpi_tpu.models import scan_steps

    grid_size = _case_grid(CASE, GRID)
    if CASE == "rod":
        # BENCH_ROD_REFRESH=flow_step measures the opt-in frozen-loads
        # approximation arm (see build_rod_fsi_step); default = the
        # reference's per-substep-refresh semantics
        fsi_step, (carry,) = _build_rod_bench_case(
            grid_size=grid_size,
            substep_load_refresh=os.environ.get(
                "BENCH_ROD_REFRESH", "every"
            ),
        )
    elif CASE == "multibody":
        fsi_step, (carry,) = _build_multibody_bench_case(
            grid_size=grid_size,
            substep_load_refresh=os.environ.get(
                "BENCH_ROD_REFRESH", "every"
            ),
        )
    elif CASE == "sphere":
        fsi_step, (carry,) = _build_fsi_case(grid_size=grid_size)
    else:
        raise ValueError(f"BENCH_CASE must be sphere|rod|multibody, got {CASE}")

    # warmup / compile
    carry, _ = scan_steps(fsi_step, carry, STEPS, donate=True)
    jax.block_until_ready(carry)

    t0 = time.perf_counter()
    carry, diag = scan_steps(fsi_step, carry, STEPS, donate=True)
    jax.block_until_ready(carry)
    t1 = time.perf_counter()

    # sparse-window cases carry per-step window_ok flags - a tripped
    # window means clipped forcing, so the number would not be honest
    for flags in jax.tree_util.tree_leaves(diag):
        if flags.dtype == bool:
            assert bool(np.all(np.asarray(flags))), "forcing window tripped"

    n_cells = int(np.prod(grid_size))
    sec_per_step = (t1 - t0) / STEPS
    mcells_per_s = n_cells / sec_per_step / 1e6
    vs_baseline = (
        round(BASELINE_SEC_PER_STEP / sec_per_step, 3)
        if BASELINE_SEC_PER_STEP is not None
        else None
    )
    grid_tag = (
        f"{GRID}cubed" if CASE == "sphere"
        else "x".join(str(g) for g in grid_size)
    )
    smi = nvidia_smi_lines()
    card = parse_nvidia_smi_line(smi[0]) if smi else {}
    print(
        json.dumps(
            {
                "metric": f"3d_fsi_{CASE}_{grid_tag}_step_throughput",
                "value": round(mcells_per_s, 3),
                "unit": "Mcells/s",
                "vs_baseline": vs_baseline,
                "sec_per_step": round(sec_per_step, 6),
                "grid": list(grid_size),
                "steps": STEPS,
                "case": CASE,
                "platform": devices[0].platform,
                "device_kind": devices[0].device_kind,
                "device_count": len(devices),
                "power_limit_w": card.get("power_limit_w"),
            }
        )
    )


if __name__ == "__main__":
    main()
