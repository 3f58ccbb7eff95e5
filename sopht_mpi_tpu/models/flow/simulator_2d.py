"""2D unbounded flow simulator (vorticity formulation).

Capability parity with ``UnboundedFlowSimulator2D``
(/root/reference/sopht_mpi/simulator/flow/flow_simulators_mpi_2d.py:20-328):
flow types ``passive_scalar`` / ``navier_stokes`` /
``navier_stokes_with_forcing``, free-stream flow, boundary sponge
penalisation, stable-timestep control, max-vorticity diagnostic.

Design: fields are ghost-free globally-shaped jax arrays
(optionally sharded over a device mesh); one ``jit``-compiled step function
advances the whole flow state. ``dt`` and the free-stream velocity are
traced arguments, so time loops never retrace. A functional core
(:func:`navier_stokes_step_2d` etc.) is exposed for fully on-device loops
(e.g. ``lax.scan``) and for composition with the FSI coupling.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sopht_mpi_tpu.ops import (
    add_fixed_val,
    advection_timestep_eno3_2d,
    diffusion_timestep_2d,
    outplane_field_curl_2d,
    penalise_field_boundary_2d,
    update_vorticity_from_velocity_forcing_2d,
    UnboundedPoissonSolver2D,
)
from sopht_mpi_tpu.parallel import (
    check_grid_divisibility,
    shard_scalar_field,
    shard_vector_field,
)
from sopht_mpi_tpu.utils.types import get_test_tol


class FlowState2D(NamedTuple):
    """Functional flow state (pytree). ``primary_scalar_field`` is the
    advected scalar for passive flows and the vorticity for Navier-Stokes
    (the reference aliases them, flow_simulators_mpi_2d.py:150-160)."""

    primary_scalar_field: jax.Array
    velocity_field: jax.Array
    eul_grid_forcing_field: jax.Array | None = None


class UnboundedFlowSimulator2D:
    """2D unbounded flow simulator.

    :param grid_size: (ny, nx) global grid size.
    :param x_range: physical length of the x side of the domain.
    :param kinematic_viscosity: fluid kinematic viscosity.
    :param CFL: advection CFL number (default 0.1, reference :29).
    :param flow_type: "passive_scalar" | "navier_stokes" |
        "navier_stokes_with_forcing".
    :param with_free_stream_flow: add a uniform free-stream velocity.
    :param real_t: field dtype (default float32, reference :32).
    :param mesh: optional jax device mesh (parallel.create_mesh); the
        JAX analogue of the reference's ``rank_distribution``.
    :param penalty_zone_width: wall sponge width in cells (default 2).
    """

    grid_dim = 2

    SUPPORTED_FLOW_TYPES = [
        "passive_scalar",
        "navier_stokes",
        "navier_stokes_with_forcing",
    ]

    def __init__(
        self,
        grid_size,
        x_range,
        kinematic_viscosity,
        time=0.0,
        CFL=0.1,
        flow_type="passive_scalar",
        with_free_stream_flow=False,
        real_t=jnp.float32,
        mesh=None,
        **kwargs,
    ):
        self.grid_size = tuple(grid_size)
        self.grid_size_y, self.grid_size_x = self.grid_size
        self.x_range = x_range
        self.real_t = real_t
        self.flow_type = flow_type
        self.with_free_stream_flow = with_free_stream_flow
        self.kinematic_viscosity = kinematic_viscosity
        self.CFL = CFL
        self.time = time
        self.mesh = mesh
        if flow_type not in self.SUPPORTED_FLOW_TYPES:
            raise ValueError("Invalid flow type given")
        if flow_type == "passive_scalar" and with_free_stream_flow:
            raise ValueError(
                "Free stream flow not defined for passive advection diffusion!"
            )
        self.penalty_zone_width = kwargs.get("penalty_zone_width", 2)
        unknown = set(kwargs) - {"penalty_zone_width"}
        if unknown:
            # a typo'd option silently running the defaults would poison
            # benchmark control arms
            raise TypeError(
                f"Unknown keyword argument(s) {sorted(unknown)}; "
                "supported: ['penalty_zone_width']"
            )
        if mesh is not None:
            check_grid_divisibility(self.grid_size, mesh)

        self._init_domain()
        self._init_fields()
        self._compile_step()

    # -- domain / fields ----------------------------------------------------

    def _init_domain(self):
        self.y_range = self.x_range * self.grid_size_y / self.grid_size_x
        self.dx = float(self.x_range / self.grid_size_x)
        eul_grid_shift = self.dx / 2.0
        x = np.linspace(
            eul_grid_shift,
            self.x_range - eul_grid_shift,
            self.grid_size_x,
        )
        y = np.linspace(
            eul_grid_shift,
            self.y_range - eul_grid_shift,
            self.grid_size_y,
        )
        # position_field[0] = x grid, [1] = y grid (reference VectorField order)
        pos = np.stack(np.meshgrid(x, y, indexing="xy")).astype(np.dtype(self.real_t))
        self.position_field = shard_vector_field(jnp.asarray(pos), self.mesh)

    def _init_fields(self):
        zeros = lambda: shard_scalar_field(
            jnp.zeros(self.grid_size, dtype=self.real_t), self.mesh
        )
        vzeros = lambda: shard_vector_field(
            jnp.zeros((self.grid_dim, *self.grid_size), dtype=self.real_t),
            self.mesh,
        )
        self.primary_scalar_field = zeros()
        self.velocity_field = vzeros()
        self.eul_grid_forcing_field = (
            vzeros() if self.flow_type == "navier_stokes_with_forcing" else None
        )
        if self.flow_type in ("navier_stokes", "navier_stokes_with_forcing"):
            self.stream_func_field = zeros()
            self.unbounded_poisson_solver = UnboundedPoissonSolver2D(
                grid_size_y=self.grid_size_y,
                grid_size_x=self.grid_size_x,
                x_range=self.x_range,
                real_t=self.real_t,
                mesh=self.mesh,
            )

    # vorticity is an alias of the primary scalar for NS flows (reference :150)
    @property
    def vorticity_field(self):
        return self.primary_scalar_field

    @vorticity_field.setter
    def vorticity_field(self, value):
        self.primary_scalar_field = value

    # -- step construction --------------------------------------------------

    def _compile_step(self):
        nu = self.kinematic_viscosity
        dx = self.dx
        penalty_width = self.penalty_zone_width
        flow_type = self.flow_type
        with_free_stream = self.with_free_stream_flow
        solver = getattr(self, "unbounded_poisson_solver", None)

        def step(
            state: FlowState2D, dt, free_stream_velocity, poisson_greens
        ) -> FlowState2D:
            return flow_step_2d(
                state,
                dt,
                free_stream_velocity,
                dx=dx,
                nu=nu,
                flow_type=flow_type,
                with_free_stream=with_free_stream,
                penalty_zone_width=penalty_width,
                poisson_solver=solver,
                poisson_greens=poisson_greens,
            )

        self._step_fn = jax.jit(step)

        def step_l1(state, dt, free_stream_velocity, poisson_greens):
            """(state, velocity |u|_1 max): in 2D the max is a plain jnp
            reduction on the new velocity - the same read the next step
            would have done for dt control, just moved to the step end."""
            new = step(state, dt, free_stream_velocity, poisson_greens)
            return new, jnp.max(jnp.sum(jnp.abs(new.velocity_field), axis=0))

        self._step_l1_fn = jax.jit(step_l1)

    @property
    def _poisson_greens(self):
        """The Fourier Green's function, passed as a traced jit argument so
        the (2N)^dim/2-sized array never becomes a compiled-in constant."""
        solver = getattr(self, "unbounded_poisson_solver", None)
        if solver is None:
            return jnp.zeros((), dtype=self.real_t)  # unused placeholder
        return solver.fourier_greens_times_dx_pow_dim

    def _get_state(self) -> FlowState2D:
        return FlowState2D(
            self.primary_scalar_field,
            self.velocity_field,
            self.eul_grid_forcing_field,
        )

    def _set_state(self, state: FlowState2D):
        self.primary_scalar_field = state.primary_scalar_field
        self.velocity_field = state.velocity_field
        self.eul_grid_forcing_field = state.eul_grid_forcing_field

    # -- public API (reference parity) --------------------------------------

    def time_step(self, dt, free_stream_velocity=(0.0, 0.0)):
        """Advance the flow by ``dt`` (reference :255-258)."""
        fsv = jnp.asarray(free_stream_velocity, dtype=self.real_t)
        self._set_state(
            self._step_fn(
                self._get_state(), self.real_t(dt), fsv, self._poisson_greens
            )
        )
        self.time += float(dt)

    def compute_stable_timestep(self, dt_prefac=1.0, precision="single") -> float:
        """CFL/diffusion-limited timestep with a global (cross-device)
        reduction (reference :300-321)."""
        dt = compute_stable_timestep_2d(
            self.velocity_field,
            CFL=self.CFL,
            dx=self.dx,
            nu=self.kinematic_viscosity,
            tol=get_test_tol(precision),
        )
        return float(dt) * dt_prefac

    def diffusion_limited_timestep(self, dt_prefac=1.0) -> float:
        """Upper bound on every CFL/diffusion timestep this simulator can
        return: the diffusion limit ``0.9 dx^2 / (2 dim nu)`` (the CFL term
        only ever shrinks it). Used to size static scan lengths (e.g. the
        dynamic rod substep cap) so in-trace counts can never clamp."""
        return float(
            dt_prefac * 0.9 * self.dx**2
            / (2 * self.grid_dim * self.kinematic_viscosity)
        )

    def get_max_vorticity(self) -> float:
        """Global maximum vorticity (reference :323-328)."""
        return float(jnp.max(self.vorticity_field))

    def compute_velocity_from_vorticity(self):
        """Recompute the velocity from the current vorticity (public
        method the reference exposes for final diagnostics,
        flow_simulators_mpi_2d.py:273-282 via lamb_oseen_vortex.py:157)."""
        vorticity, velocity, _ = compute_velocity_from_vorticity_2d(
            self.vorticity_field,
            dx=self.dx,
            penalty_zone_width=self.penalty_zone_width,
            poisson_solver=self.unbounded_poisson_solver,
        )
        self.vorticity_field = vorticity
        self.velocity_field = velocity


# ---------------------------------------------------------------------------
# Functional core
# ---------------------------------------------------------------------------


def advection_and_diffusion_timestep_2d(field, velocity, dt, *, dx, nu):
    """ENO3 advection + Euler-forward diffusion (reference :260-271)."""
    real_t = field.dtype
    field = advection_timestep_eno3_2d(
        field, velocity, jnp.asarray(dt / dx, real_t)
    )
    field = diffusion_timestep_2d(field, jnp.asarray(nu * dt / dx / dx, real_t))
    return field


def compute_velocity_from_vorticity_2d(
    vorticity, *, dx, penalty_zone_width, poisson_solver, poisson_greens=None
):
    """Penalise vorticity toward the walls, solve for the streamfunction,
    curl it into the velocity (reference :273-282)."""
    vorticity = penalise_field_boundary_2d(vorticity, penalty_zone_width)
    stream_func = poisson_solver.solve(vorticity, poisson_greens)
    velocity = outplane_field_curl_2d(
        stream_func, jnp.asarray(0.5 / dx, vorticity.dtype)
    )
    return vorticity, velocity, stream_func


def flow_step_2d(
    state: FlowState2D,
    dt,
    free_stream_velocity,
    *,
    dx,
    nu,
    flow_type,
    with_free_stream,
    penalty_zone_width,
    poisson_solver,
    poisson_greens=None,
) -> FlowState2D:
    """One full flow timestep; pure function, jit/scan-safe.

    Ordering matches the reference timestep dispatch (:284-298):
    [forcing: vorticity += dt/(2dx) curl(f)] -> advect+diffuse ->
    [NS: penalise walls -> Poisson -> curl -> free stream] ->
    [forcing: reset forcing field].
    """
    field = state.primary_scalar_field
    velocity = state.velocity_field
    forcing = state.eul_grid_forcing_field
    real_t = field.dtype

    if flow_type == "navier_stokes_with_forcing":
        field = update_vorticity_from_velocity_forcing_2d(
            field, forcing, jnp.asarray(dt / (2.0 * dx), real_t)
        )

    field = advection_and_diffusion_timestep_2d(field, velocity, dt, dx=dx, nu=nu)

    if flow_type in ("navier_stokes", "navier_stokes_with_forcing"):
        field, velocity, _ = compute_velocity_from_vorticity_2d(
            field,
            dx=dx,
            penalty_zone_width=penalty_zone_width,
            poisson_solver=poisson_solver,
            poisson_greens=poisson_greens,
        )
        if with_free_stream:
            velocity = add_fixed_val(velocity, free_stream_velocity)

    if flow_type == "navier_stokes_with_forcing":
        forcing = jnp.zeros_like(forcing)

    return FlowState2D(field, velocity, forcing)


@functools.partial(jax.jit, static_argnames=("CFL", "dx", "nu", "tol"))
def compute_stable_timestep_2d(velocity_field, *, CFL, dx, nu, tol):
    """min(CFL dx / max|u|_1, 0.9 dx^2 / (2 dim nu)) with a global max
    (the reference's MIN-allreduce, :320)."""
    velocity_mag = jnp.sum(jnp.abs(velocity_field), axis=0)
    dt_advection = CFL * dx / (jnp.max(velocity_mag) + tol)
    dt_diffusion = 0.9 * dx**2 / (2 * 2) / (nu + tol)
    return jnp.minimum(dt_advection, dt_diffusion)
