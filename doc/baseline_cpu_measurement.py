"""Measured CPU baseline for bench.py's ``vs_baseline`` (BASELINE.md:21-24).

The reference MPI stack (mpi4py + FFTW/mpi4py-fft + pystencils + sopht)
cannot be provisioned in this environment (no egress, no preinstalled MPI),
so per the BASELINE.md fallback this script measures THIS repo's own
XLA-CPU path -- the same fused flow-past-sphere FSI step bench.py times on
the GPU -- on the host CPU at 64^3 / 128^3 / 256^3, and derives the 64-rank
CPU reference wall-time/step at 256^3 under an IDEAL linear-scaling
assumption (64x speedup over one core, zero MPI overhead), which is
strictly generous to the reference.

Run:  python doc/baseline_cpu_measurement.py
Writes doc/baseline_cpu_measured.json; bench.py's BASELINE_SEC_PER_STEP
must match the derived value there.
"""

import json
import os
import platform
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


CASE = os.environ.get("BASELINE_CASE", "sphere")


def measure(grid, steps):
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench
    from __graft_entry__ import (
        _build_fsi_case,
        _build_multibody_bench_case,
        _build_rod_bench_case,
    )
    from sopht_mpi_tpu.models import scan_steps

    # dense reference-shaped IBM path (full-field spread + forcing pass,
    # the computation the reference's per-rank loop actually performs) -
    # the baseline must not inherit this repo's sparse-window optimization.
    # Case grids use the SAME aspect mapping as bench.py (_case_grid).
    grid_size = bench._case_grid(CASE, grid)
    if CASE == "rod":
        fsi_step, (carry,) = _build_rod_bench_case(
            grid_size=grid_size, sparse_forcing=False
        )
    elif CASE == "multibody":
        fsi_step, (carry,) = _build_multibody_bench_case(
            grid_size=grid_size, sparse_forcing=False
        )
    else:
        fsi_step, (carry,) = _build_fsi_case(
            grid_size=grid_size, sparse_forcing=False
        )
    # warmup/compile with the SAME static n_steps as the timed call:
    # n_steps is a static jit argument, so a different warmup length would
    # leave the timed call to retrace+recompile inside the timer
    carry, _ = scan_steps(fsi_step, carry, steps, donate=True)
    jax.block_until_ready(carry)
    t0 = time.perf_counter()
    carry, _ = scan_steps(fsi_step, carry, steps, donate=True)
    jax.block_until_ready(carry)
    t1 = time.perf_counter()
    return (t1 - t0) / steps


def _cpu_model():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


_DEFAULT = ((64, 5), (128, 3), (256, 2))
_STEPS = {64: 5, 128: 3, 256: 2, 512: 1}


def main():
    ncores = os.cpu_count()
    grids_env = os.environ.get("BASELINE_GRIDS")
    plan = (
        tuple((int(g), _STEPS.get(int(g), 1)) for g in grids_env.split(","))
        if grids_env
        else _DEFAULT
    )
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "baseline_cpu_measured.json"
    )
    # MERGE into the existing artifact so adding one grid (e.g.
    # BASELINE_GRIDS=512 for the bench's 512^3 vs_baseline) or one case
    # (BASELINE_CASE=rod) keeps the other recorded measurements intact
    try:
        with open(path) as f:
            prior_doc = json.load(f)
    except (OSError, ValueError):
        prior_doc = {}
    if CASE == "sphere":
        prior = prior_doc.get("measured_sec_per_step_1core", {})
    else:
        prior = (
            prior_doc.get("cases", {})
            .get(CASE, {})
            .get("measured_sec_per_step_1core", {})
        )
    results = {int(g): float(s) for g, s in prior.items()}
    import bench

    for grid, steps in plan:
        sec = measure(grid, steps)
        results[grid] = sec
        n_cells = 1
        for g in bench._case_grid(CASE, grid):
            n_cells *= g
        print(
            f"{CASE} G={grid} {bench._case_grid(CASE, grid)}: {sec:.3f} "
            f"s/step ({n_cells / sec / 1e6:.2f} Mcells/s)",
            flush=True,
        )

    ranks = 64
    table = {str(g): round(results[g], 4) for g in sorted(results)}
    out = {
        "host": platform.processor() or platform.machine(),
        "cpu_model": _cpu_model(),
        "n_cores": ncores,
        "backend": "XLA CPU (this repo's jnp path, same fused FSI step as bench.py)",
        "measured_sec_per_step_1core": prior_doc.get(
            "measured_sec_per_step_1core", {}
        ),
        "assumed_ranks": ranks,
        "scaling_assumption": "ideal linear (64x over 1 core, zero comm overhead)",
        "cases": prior_doc.get("cases", {}),
    }
    if CASE == "sphere":
        out["measured_sec_per_step_1core"] = table
    else:
        out["cases"].setdefault(CASE, {})["measured_sec_per_step_1core"] = table
        out["cases"][CASE]["grid_aspect"] = list(bench._case_grid(CASE, 256))
        out["cases"][CASE]["note"] = (
            "dense reference-shaped IBM path; grid key G maps to shape via "
            "bench._case_grid"
        )
    sphere_tbl = out["measured_sec_per_step_1core"]
    if "256" in sphere_tbl:
        out["derived_baseline_sec_per_step_256cubed_64rank"] = round(
            float(sphere_tbl["256"]) / ranks, 4
        )
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
