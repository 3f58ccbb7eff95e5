"""Smoke check of the coupled FSI step on NVIDIA GPUs.

Drives the system's main path through the entry points a user calls and
checks what comes out, phase by phase:

1. device: refuses anything but a GPU (no CPU fallback); prints the card's
   name and power limit, the JAX version and the compile-cache directory;
2. main path: flow past a sphere at 256^3 with the reference's marker
   sizing (10 donated steps through ``models.scan_steps``), then the
   flexible rod at (256, 64, 256) and rod + sphere at (128, 128, 256), both
   at the reference's per-substep load refresh. Prints compile seconds,
   ``memory_analysis()``, peak device memory and seconds per step, and
   checks that every field is finite and every sparse-forcing window held;
3. the 256^3 Poisson solve against a numpy float64 dense doubled-domain
   convolution built on the host (relative L2 <= 1e-5: an f32 FFT solve
   is in the 1e-7..1e-6 class, while a wrong pad or truncation, or a TF32
   or bf16 path, shows at 1e-3 or more);
4. small cases on the card against the same cases on this process's CPU
   backend, 3 steps from the same inputs (vorticity to 3e-5 of its scale,
   rod tip to 1e-5: sums run in another order, and cuFFT rounds otherwise
   than pocketfft). The sphere is the bench case at 64^3; the rod and the
   rod + sphere are ``dryrun_multichip``'s 32^3 cases, whose penalty
   stiffness (1e3) keeps rounding-level differences at rounding level,
   and ``rod-gather`` is that rod tilted off the grid axes with 4 rod
   substeps per flow step on the gathered substep E->L path. The bench
   rod cases' stiffness (2e5) turns a 1e-7 difference in a marker
   position into an O(1e-2) force difference, which no such tolerance
   can hold. Each rod line also prints how far the tip moved;
5. a TF32 tripwire: the small rod, multibody and rod-gather cases under
   the default matmul precision against
   ``jax.default_matmul_precision("highest")`` (1e-6 relative; an
   unpinned f32 contraction that runs in TF32 fails), and its control:
   ``rod-gather`` with every ``jnp.einsum``/``jnp.matmul`` unpinned and
   its operands rounded to TF32's 10-bit mantissa must differ by more
   than that tolerance, in the vorticity (the IBM transfers) and in the
   rod (the Cosserat contractions) both.

``--four-cards`` runs only the sharded comparison instead: the sphere at
256^3 on (4, 1) and (2, 2) meshes at ``overlap_chunks`` 4 and 1, and the
rod at (256, 64, 256) on (4, 1), 3 steps each against the same case on
one card at the phase-4 tolerances. Each arm prints its set-up, compile
and first-run seconds and the step time of its compiled program re-run
from the same inputs; an arm that outlasts ``ARM_LIMIT_S`` dumps every
thread's stack and ends the process.

Run from the repository root: ``python chip_smoke.py`` (one GPU) or
``python chip_smoke.py --four-cards``. On success the last line of stdout
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``
with N the number of cards the run used; if any phase fails the script
exits non-zero without it.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import gc
import json
import os
import sys
import time
import traceback

import numpy as np

SPHERE_GRID = (256, 256, 256)
ROD_GRID = (256, 64, 256)
MULTIBODY_GRID = (128, 128, 256)
# the card-vs-CPU cases (see phase 4 above)
SMALL_GRIDS = {"sphere": (64, 64, 64), "rod": (32, 32, 32),
               "multibody": (32, 32, 32), "rod-gather": (32, 32, 32)}
MAIN_STEPS = 10
COMPARE_STEPS = 3
# (case, mesh shape, overlap_chunks) of --four-cards; the (2, 2) arms run
# last, as their first run has hung on four H100s (ROADMAP R2)
FOUR_CARD_ARMS = (("sphere", (4, 1), 4), ("sphere", (4, 1), 1),
                  ("rod", (4, 1), None), ("sphere", (2, 2), 4),
                  ("sphere", (2, 2), 1))
ARM_LIMIT_S = 120

VORTICITY_RTOL = 3e-5  # of max(1, max |omega|); dryrun_multichip's bound
ROD_ATOL = 1e-5
POISSON_RTOL = 1e-5
TF32_RTOL = 1e-6


def jax_platforms_with_cpu(value: str | None) -> str | None:
    """``JAX_PLATFORMS`` extended by the CPU backend, which phase 4
    compares the card with; an unset value already includes it."""
    if not value:
        return value
    names = [v.strip() for v in value.split(",")]
    return value if "cpu" in names else value + ",cpu"


def _build(case, grid, mesh=None, sim_kwargs=None, small=False):
    """A case through the ``__graft_entry__`` builders: the bench cases,
    or with ``small`` the rod and multibody cases of ``dryrun_multichip``
    and the tilted, substepped rod on the gathered E->L path; returns
    (step, carry)."""
    import __graft_entry__ as entry

    if small and case == "rod":
        return entry._build_rod_fsi_case(grid, mesh=mesh)
    if small and case == "rod-gather":
        return entry._build_rod_fsi_case(
            grid, mesh=mesh, sparse_forcing=True, rod_substeps=4,
            substep_interp="gather", direction=(0.6, 0.8, 0.0),
        )
    if small and case == "multibody":
        return entry._build_multibody_case(grid, mesh=mesh)
    if case == "sphere":
        step, (carry,) = entry._build_fsi_case(
            grid_size=grid, mesh=mesh, sim_kwargs=sim_kwargs
        )
    elif case == "rod":
        step, (carry,) = entry._build_rod_bench_case(
            grid_size=grid, mesh=mesh, substep_load_refresh="every"
        )
    elif case == "multibody":
        step, (carry,) = entry._build_multibody_bench_case(
            grid_size=grid, mesh=mesh, substep_load_refresh="every"
        )
    else:
        raise ValueError(case)
    return step, carry


def _rod_position(case, carry):
    if case == "multibody":
        return np.asarray(carry.body_states[0].position)
    if case.startswith("rod"):
        return np.asarray(carry.rod_state.position)
    return None


def _outputs(case, carry) -> dict:
    out = {"vorticity": np.asarray(carry.flow_state.primary_field)}
    rod = _rod_position(case, carry)
    if rod is not None:
        out["rod"] = rod
    return out


def _check_state(carry, diag):
    """Every floating leaf finite; every sparse-forcing window flag (the
    boolean diagnostics) held on every step."""
    import jax

    for leaf in jax.tree_util.tree_leaves(carry):
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all():
            raise AssertionError(f"non-finite values in a {a.shape} field")
    flags = [np.asarray(x) for x in jax.tree_util.tree_leaves(diag)
             if np.asarray(x).dtype == bool]
    if not all(f.all() for f in flags):
        raise AssertionError("a sparse-forcing window tripped")
    return len(flags)


def _run(case, grid, n_steps, small=False):
    """Build a case, roll ``n_steps`` and check it; returns its outputs,
    with ``tip_moved`` (how far the rod tip went) for the rod cases."""
    import jax

    from sopht_mpi_tpu.models import scan_steps

    step, carry = _build(case, grid, small=small)
    start = _rod_position(case, carry)
    carry, diag = scan_steps(step, carry, n_steps)
    jax.block_until_ready(carry)
    _check_state(carry, diag)
    out = _outputs(case, carry)
    if start is not None:
        out["tip_moved"] = float(np.abs(out["rod"][:, -1]
                                        - start[:, -1]).max())
    return out


def _rel_diff(a, b) -> float:
    """max |a - b| over max(1, max |b|)."""
    return float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))


def _compare(label, case, got, ref, vort_rtol, rod_atol, failures):
    rows = [("vorticity", _rel_diff(got["vorticity"], ref["vorticity"]),
             vort_rtol, "")]
    if "rod" in ref:
        moved = (f" (tip moved {ref['tip_moved']:.3e})"
                 if "tip_moved" in ref else "")
        rows.append(("rod tip", float(np.abs(
            got["rod"][:, -1] - ref["rod"][:, -1]).max()), rod_atol, moved))
    for what, err, tol, note in rows:
        ok = err <= tol
        print(f"  {label} {case:<10s} {what:<9s} err={err:.3e} "
              f"tol={tol:.1e} {'PASS' if ok else 'FAIL'}{note}", flush=True)
        if not ok:
            failures.append(f"{label} {case} {what}")


def phase_device(n_cards):
    import jax

    from sopht_mpi_tpu.utils.compile_cache import configure_compile_cache
    from sopht_mpi_tpu.utils.device import nvidia_smi_lines, require_gpu

    devices = require_gpu(jax.devices())
    for line in nvidia_smi_lines() or ["nvidia-smi: not available"]:
        print(line, flush=True)
    print(f"jax {jax.__version__}; devices: {len(devices)} x "
          f"{devices[0].device_kind}, this run uses {n_cards}; compile "
          f"cache: {configure_compile_cache()}", flush=True)
    if len(devices) < n_cards:
        raise SystemExit(f"needs {n_cards} GPUs; found {len(devices)}")
    return devices[:n_cards]


def phase_main_path(cases=(("sphere", SPHERE_GRID), ("rod", ROD_GRID),
                           ("multibody", MULTIBODY_GRID)),
                    n_steps=MAIN_STEPS):
    """The bench cases at full size with donation, as ``bench.py`` runs
    them."""
    import jax

    from sopht_mpi_tpu.models import fsi, scan_steps

    device = jax.devices()[0]
    for case, grid in cases:
        t0 = time.perf_counter()
        step, carry = _build(case, grid)
        jax.block_until_ready(carry)
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        carry, diag = scan_steps(step, carry, n_steps, donate=True)
        jax.block_until_ready(carry)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        carry, diag = scan_steps(step, carry, n_steps, donate=True)
        jax.block_until_ready(carry)
        steady = time.perf_counter() - t0
        n_flags = _check_state(carry, diag)
        mem = fsi._scan_steps_donated.lower(
            step, carry._replace(greens=None), carry.greens, n_steps
        ).compile().memory_analysis()
        stats = device.memory_stats() or {}
        print(
            f"  {case} {grid}: set-up {setup:.2f} s, compile ~"
            f"{first - steady:.2f} s (first call {first:.3f} s minus a "
            f"compiled one), {steady / n_steps:.6f} s/step over {n_steps} "
            f"steps; window flags checked: {n_flags}",
            flush=True,
        )
        if mem is not None:
            print(
                f"    memory_analysis: arguments "
                f"{mem.argument_size_in_bytes / 2**30:.3f} GiB, outputs "
                f"{mem.output_size_in_bytes / 2**30:.3f} GiB, temporaries "
                f"{mem.temp_size_in_bytes / 2**30:.3f} GiB, aliased "
                f"{mem.alias_size_in_bytes / 2**30:.3f} GiB",
                flush=True,
            )
        print(f"    peak_bytes_in_use so far: "
              f"{stats.get('peak_bytes_in_use', 0) / 2**30:.3f} GiB",
              flush=True)
        del carry, diag


def dense_free_space_solve_f64(rhs, dx):
    """Host float64 reference of the 3D free-space solve: the doubled
    domain's even-reflected Green's function ``1/(4 pi r)`` (origin
    ``1/(4 pi dx)``) built in float64, one dense FFT convolution, the
    first N cells kept. Returns (solution, real Fourier Green's function
    times dx^3)."""
    import scipy.fft as sfft

    doubled = tuple(2 * n for n in rhs.shape)
    dist = [np.minimum(np.arange(m), m - np.arange(m)) * dx for m in doubled]
    r = np.sqrt(dist[0][:, None, None] ** 2 + dist[1][None, :, None] ** 2
                + dist[2][None, None, :] ** 2)
    with np.errstate(divide="ignore"):
        g = 1.0 / (4.0 * np.pi * r)
    g[0, 0, 0] = 1.0 / (4.0 * np.pi * dx)
    del r
    ghat = sfft.rfftn(g, workers=-1).real * dx**3
    del g
    sol = sfft.irfftn(
        sfft.rfftn(rhs.astype(np.float64), doubled, workers=-1) * ghat,
        doubled, workers=-1,
    )
    return sol[tuple(slice(0, n) for n in rhs.shape)], ghat


def phase_poisson(grid=SPHERE_GRID, failures=None, seed=0):
    import jax
    import jax.numpy as jnp

    from sopht_mpi_tpu.ops import UnboundedPoissonSolver3D

    solver = UnboundedPoissonSolver3D(*grid, x_range=1.0)
    rhs = np.random.default_rng(seed).standard_normal(grid).astype(
        np.float32)
    sol = jax.jit(solver.solve)(
        jnp.asarray(rhs), solver.fourier_greens_times_dx_pow_dim
    )
    sol = np.asarray(sol, np.float64)
    ref, ghat = dense_free_space_solve_f64(rhs, solver.dx)
    greens = np.asarray(solver.fourier_greens_times_dx_pow_dim, np.float64)
    for what, got, want in (("solve", sol, ref),
                            ("Green's spectrum", greens, ghat)):
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        ok = err <= POISSON_RTOL
        print(f"  poisson {grid} {what}: rel L2 {err:.3e} "
              f"(tol {POISSON_RTOL:.0e}) {'PASS' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"poisson {what}")


def phase_card_vs_cpu(cpu, grids=SMALL_GRIDS, failures=None):
    """Returns the card's outputs per case (phase 5 reuses them)."""
    import jax

    card = {}
    for case, grid in grids.items():
        card[case] = _run(case, grid, COMPARE_STEPS, small=True)
        with jax.default_device(cpu):
            host = _run(case, grid, COMPARE_STEPS, small=True)
        _compare("card-vs-cpu", case, card[case], host, VORTICITY_RTOL,
                 ROD_ATOL, failures)
    return card


@contextlib.contextmanager
def tf32_contractions():
    """Within the block, ``jnp.einsum`` and ``jnp.matmul`` drop their
    ``precision`` pin and round float operands to TF32's 10-bit mantissa:
    what an unpinned contraction on tensor cores computes. The control
    of the TF32 tripwire."""
    import jax
    import jax.numpy as jnp

    orig_einsum, orig_matmul = jnp.einsum, jnp.matmul

    def tf32(x):
        x = jnp.asarray(x)
        if not jnp.issubdtype(x.dtype, jnp.floating):
            return x
        return jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=10)

    def einsum(spec, *operands, precision=None, **kwargs):
        return orig_einsum(spec, *map(tf32, operands), **kwargs)

    def matmul(a, b, precision=None, **kwargs):
        return orig_matmul(tf32(a), tf32(b), **kwargs)

    jnp.einsum, jnp.matmul = einsum, matmul
    try:
        yield
    finally:
        jnp.einsum, jnp.matmul = orig_einsum, orig_matmul


def phase_tf32(card, grids=SMALL_GRIDS, failures=None):
    import jax

    for case in ("rod", "multibody", "rod-gather"):
        with jax.default_matmul_precision("highest"):
            highest = _run(case, grids[case], COMPARE_STEPS, small=True)
        for what in ("vorticity", "rod"):
            err = _rel_diff(card[case][what], highest[what])
            ok = err <= TF32_RTOL
            print(f"  default-vs-highest {case:<10s} {what:<9s} "
                  f"err={err:.3e} tol={TF32_RTOL:.0e} "
                  f"{'PASS' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"tf32 {case} {what}")
    case = "rod-gather"
    with tf32_contractions():
        unpinned = _run(case, grids[case], COMPARE_STEPS, small=True)
    for what in ("vorticity", "rod"):
        err = _rel_diff(unpinned[what], card[case][what])
        fired = err > TF32_RTOL
        print(f"  control: unpinned TF32 {case} {what:<9s} err={err:.3e} "
              f"must exceed {TF32_RTOL:.0e}: "
              f"{'FIRES' if fired else 'SILENT (FAIL)'}", flush=True)
        if not fired:
            failures.append(f"tf32 control {what}")


def _compiled_run(case, grid, mesh=None, sim_kwargs=None):
    """Build a bench case, compile ``COMPARE_STEPS`` steps ahead of time,
    run them, then re-run the compiled program from the same inputs to
    time it; returns (outputs, seconds by part)."""
    import jax

    from sopht_mpi_tpu.models import fsi

    t0 = time.perf_counter()
    step, carry = _build(case, grid, mesh, sim_kwargs)
    jax.block_until_ready(carry)
    t1 = time.perf_counter()
    compiled = fsi._scan_steps.lower(step, carry, COMPARE_STEPS).compile()
    t2 = time.perf_counter()
    final, diag = compiled(carry)
    jax.block_until_ready(final)
    t3 = time.perf_counter()
    _check_state(final, diag)
    out = _outputs(case, final)
    del final, diag
    t4 = time.perf_counter()
    jax.block_until_ready(compiled(carry))
    sec = (time.perf_counter() - t4) / COMPARE_STEPS
    return out, {"set-up": t1 - t0, "compile": t2 - t1,
                 "first run": t3 - t2, "s/step": sec}


def _times(parts) -> str:
    return (f"set-up {parts['set-up']:.2f} s, compile {parts['compile']:.2f}"
            f" s, first run {parts['first run']:.3f} s, "
            f"{parts['s/step']:.6f} s/step")


def phase_four_cards(devices, sphere_grid=SPHERE_GRID, rod_grid=ROD_GRID,
                     failures=None, arms=FOUR_CARD_ARMS):
    """Sharded runs on four devices against the same case on one."""
    import jax

    from sopht_mpi_tpu.parallel import create_mesh

    grids = {"sphere": sphere_grid, "rod": rod_grid}
    t_phase = time.perf_counter()
    single = {}
    for case in sorted({arm[0] for arm in arms}):
        faulthandler.dump_traceback_later(ARM_LIMIT_S, exit=True)
        single[case], parts = _compiled_run(case, grids[case])
        faulthandler.cancel_dump_traceback_later()
        print(f"  [{time.perf_counter() - t_phase:6.1f} s] one card {case} "
              f"{grids[case]}: {_times(parts)}", flush=True)
        jax.clear_caches()
        gc.collect()
    for case, mesh_shape, chunks in arms:
        faulthandler.dump_traceback_later(ARM_LIMIT_S, exit=True)
        mesh = create_mesh(3, mesh_shape, devices=devices[:4])
        kwargs = None if chunks is None else {"overlap_chunks": chunks}
        out, parts = _compiled_run(case, grids[case], mesh, kwargs)
        faulthandler.cancel_dump_traceback_later()
        label = f"mesh {mesh_shape} chunks={chunks or 'default'}"
        _compare(label, case, out, single[case], VORTICITY_RTOL, ROD_ATOL,
                 failures)
        print(f"  [{time.perf_counter() - t_phase:6.1f} s] {label} {case} "
              f"{grids[case]}: {_times(parts)}", flush=True)
        del out
        jax.clear_caches()
        gc.collect()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the sharded comparison on four GPUs",
    )
    args = parser.parse_args(argv)
    platforms = jax_platforms_with_cpu(os.environ.get("JAX_PLATFORMS"))
    if platforms:
        os.environ["JAX_PLATFORMS"] = platforms

    import jax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    print("phase 1: device", flush=True)
    devices = phase_device(4 if args.four_cards else 1)
    failures = []

    def phase(name, fn, *fn_args):
        print(name, flush=True)
        t0 = time.perf_counter()
        try:
            result = fn(*fn_args)
        except Exception:  # report, run the other phases, then fail
            traceback.print_exc()
            failures.append(name)
            result = None
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
        return result

    if args.four_cards:
        phase("four cards: sharded vs one card", phase_four_cards,
              devices, SPHERE_GRID, ROD_GRID, failures)
    else:
        phase("phase 2: main path", phase_main_path)
        phase("phase 3: Poisson solve vs float64 host reference",
              phase_poisson, SPHERE_GRID, failures)
        card = phase("phase 4: card vs CPU", phase_card_vs_cpu,
                     jax.devices("cpu")[0], SMALL_GRIDS, failures)
        if card is None:
            failures.append("phase 5: no phase-4 outputs to compare")
        else:
            phase("phase 5: TF32 tripwire", phase_tf32, card, SMALL_GRIDS,
                  failures)
    if failures:
        print(f"FAILED: {failures}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
