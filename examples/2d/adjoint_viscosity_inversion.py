"""Adjoint-based parameter inversion THROUGH the flow solver: recover the
kinematic viscosity of a Lamb-Oseen vortex from one observed late-time
vorticity field by gradient descent on the solver itself.

This is a capability the reference architecture cannot offer: its
pystencils/numba kernels and MPI halo choreography are not differentiable,
while here the whole rollout - ENO3 advection, diffusion, wall
penalisation, unbounded Poisson velocity recovery - is one pure jitted function, so
``jax.value_and_grad`` of a data-misfit loss w.r.t. a physical parameter
is exact reverse-mode calculus, not finite differences.

Setup: the "measurement" is the vorticity field after evolving the
analytical Lamb-Oseen initial condition (nu_true) for ``n_steps`` of the
real solver. Starting from a wrong guess (default 2x off), Adam on
log(nu) against ``mean((omega_sim(nu) - omega_obs)^2)`` recovers nu_true
to ~0.1% in 70 iterations (measured 0.12% at the defaults in float64 on
the CPU; --precision single also converges).

Run:  python examples/2d/adjoint_viscosity_inversion.py
      python examples/2d/adjoint_viscosity_inversion.py --iters 60
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

from lamb_oseen_vortex import (
    compute_lamb_oseen_velocity,
    compute_lamb_oseen_vorticity,
)


def adjoint_viscosity_inversion_case(
    grid_size=(64, 64),
    nu_true=1e-3,
    nu_guess_factor=2.0,
    n_steps=160,
    iters=70,
    learning_rate=0.15,
    precision="double",
):
    """Returns (nu_recovered, nu_true, relative_error, loss_history)."""
    import jax

    if precision == "double":
        # outside pytest (whose conftest does this) x64 must be enabled
        # explicitly, or every float64 array silently truncates to f32.
        # It is a PROCESS-GLOBAL JAX setting; the run stays on whatever
        # device the process has.
        if not jax.config.jax_enable_x64:
            jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import optax

    from sopht_mpi_tpu.models import UnboundedFlowSimulator2D
    from sopht_mpi_tpu.models.flow.simulator_2d import (
        FlowState2D,
        flow_step_2d,
    )
    from sopht_mpi_tpu.utils import get_real_t, logger

    real_t = get_real_t(precision)
    x_range = 1.0
    t_start = 1.0
    x_cm = y_cm = 0.5  # centered: the vortex must stay away from walls
    gamma = 4 * np.pi * nu_true * t_start  # max vorticity = 1 at t_start

    flow_sim = UnboundedFlowSimulator2D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=nu_true,
        flow_type="navier_stokes",
        with_free_stream_flow=False,
        real_t=real_t,
        time=t_start,
    )
    x = np.asarray(flow_sim.position_field[0])
    y = np.asarray(flow_sim.position_field[1])
    # the observed INITIAL state (shared by truth and inversion: only the
    # dynamics' nu is unknown)
    omega0 = jnp.asarray(
        compute_lamb_oseen_vorticity(x, y, x_cm, y_cm, nu_true, gamma, t_start),
        real_t,
    )
    u0 = jnp.asarray(
        compute_lamb_oseen_velocity(x, y, x_cm, y_cm, nu_true, gamma, t_start),
        real_t,
    )
    state0 = FlowState2D(omega0, u0, None)
    # fixed dt (stable for the largest nu the optimizer will visit; the
    # CFL/diffusion controller itself is velocity-dependent and would add
    # a harmless but noisy dt-sensitivity term to the gradient)
    dt = real_t(0.25 * flow_sim.compute_stable_timestep())
    solver = flow_sim.unbounded_poisson_solver
    greens = flow_sim._poisson_greens
    zero_fsv = jnp.zeros(2, real_t)

    def rollout(nu, greens):
        def body(state, _):
            state = flow_step_2d(
                state, dt, zero_fsv,
                dx=flow_sim.dx, nu=nu, flow_type="navier_stokes",
                with_free_stream=False,
                penalty_zone_width=flow_sim.penalty_zone_width,
                poisson_solver=solver, poisson_greens=greens,
            )
            return state, None
        return jax.lax.scan(body, state0, None, length=n_steps)[0]

    omega_obs = jax.jit(rollout)(real_t(nu_true), greens).primary_scalar_field

    @jax.jit
    def loss_fn(log_nu, greens):
        omega = rollout(jnp.exp(log_nu), greens).primary_scalar_field
        return jnp.mean((omega - omega_obs) ** 2)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    log_nu = jnp.asarray(np.log(nu_guess_factor * nu_true), real_t)
    # cosine-decayed Adam: the misfit valley is narrow in log(nu), so a
    # constant step oscillates around the optimum instead of settling
    opt = optax.adam(optax.cosine_decay_schedule(learning_rate, iters))
    opt_state = opt.init(log_nu)
    history = []
    best = (np.inf, float(log_nu))
    for it in range(iters):
        val, g = value_and_grad(log_nu, greens)
        history.append(float(val))
        if float(val) < best[0]:
            best = (float(val), float(log_nu))
        if it % 5 == 0 or it == iters - 1:
            logger.info(
                f"iter {it:3d}: loss {float(val):.3e} at "
                f"nu {float(jnp.exp(log_nu)):.6e} (true {nu_true:.6e})"
            )
        updates, opt_state = opt.update(g, opt_state)
        log_nu = optax.apply_updates(log_nu, updates)
    # score the post-final-update point too (under a decayed schedule it
    # is often the closest), then report the best iterate: Adam rings
    # around the (exactly-zero-loss) optimum, and the lowest-misfit nu is
    # the estimator
    final_val = float(loss_fn(log_nu, greens))
    history.append(final_val)
    if final_val < best[0]:
        best = (final_val, float(log_nu))
    nu_rec = float(np.exp(best[1]))
    rel_err = abs(nu_rec - nu_true) / nu_true
    logger.info(
        f"recovered nu = {nu_rec:.6e}, true = {nu_true:.6e}, "
        f"relative error = {rel_err:.2%}"
    )
    return nu_rec, nu_true, rel_err, history


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--grid-size", type=int, default=64)
    parser.add_argument("--n-steps", type=int, default=160)
    parser.add_argument("--iters", type=int, default=70)
    parser.add_argument("--nu-guess-factor", type=float, default=2.0)
    parser.add_argument("--precision", default="double")
    args = parser.parse_args()

    from sopht_mpi_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    adjoint_viscosity_inversion_case(
        grid_size=(args.grid_size, args.grid_size),
        n_steps=args.n_steps,
        iters=args.iters,
        nu_guess_factor=args.nu_guess_factor,
        precision=args.precision,
    )
