"""3D unbounded flow simulator (rotational-form vorticity NS).

Capability parity with ``UnboundedFlowSimulator3D``
(/root/reference/sopht_mpi/simulator/flow/flow_simulators_mpi_3d.py:24-476):
flow types ``passive_scalar`` / ``passive_vector`` / ``navier_stokes`` /
``navier_stokes_with_forcing``, optional Laplacian vorticity filtering,
vector Poisson velocity recovery, divergence/max-vorticity diagnostics.

The Navier-Stokes transport is the rotational form (reference :395-413):
``omega += dt/(2dx) curl(u x omega)`` then vector diffusion, then optional
filtering, then velocity recovery (wall penalisation -> 3 Poisson solves ->
curl -> free stream).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sopht_mpi_tpu.ops import (
    add_fixed_val,
    advection_timestep_eno3_3d,
    advection_timestep_eno3_vector_3d,
    cross_product_3d,
    curl_3d,
    diffusion_timestep_3d,
    diffusion_timestep_vector_3d,
    divergence_3d,
    laplacian_filter_vector_3d,
    penalise_field_boundary_vector_3d,
    update_vorticity_from_velocity_forcing_3d,
    UnboundedPoissonSolver3D,
)
from sopht_mpi_tpu.parallel import (
    check_grid_divisibility,
    shard_scalar_field,
    shard_vector_field,
)
from sopht_mpi_tpu.utils.types import get_test_tol


class FlowState3D(NamedTuple):
    """``primary_field`` is the advected scalar for passive_scalar flows,
    and the (3, nz, ny, nx) vorticity / passive vector otherwise."""

    primary_field: jax.Array
    velocity_field: jax.Array
    eul_grid_forcing_field: jax.Array | None = None


class UnboundedFlowSimulator3D:
    """3D unbounded flow simulator.

    :param grid_size: (nz, ny, nx).
    :param filter_vorticity: apply the Laplacian filter for stability
        (reference :90-105; default filter_setting_dict
        ``{"order": 2, "type": "multiplicative"}``).
    :param mesh: device mesh from parallel.create_mesh(3, ...) - slab
        (n, 1) or pencil (pz, py).
    """

    grid_dim = 3

    SUPPORTED_FLOW_TYPES = [
        "passive_scalar",
        "passive_vector",
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
        filter_vorticity=False,
        **kwargs,
    ):
        self.grid_size = tuple(grid_size)
        self.grid_size_z, self.grid_size_y, self.grid_size_x = self.grid_size
        self.x_range = x_range
        self.real_t = real_t
        self.flow_type = flow_type
        self.with_free_stream_flow = with_free_stream_flow
        self.kinematic_viscosity = kinematic_viscosity
        self.CFL = CFL
        self.time = time
        self.mesh = mesh
        self.filter_vorticity = filter_vorticity
        if flow_type not in self.SUPPORTED_FLOW_TYPES:
            raise ValueError("Invalid flow type given")
        if (
            flow_type in ("passive_scalar", "passive_vector")
            and with_free_stream_flow
        ):
            raise ValueError(
                "Free stream flow not defined for passive advection diffusion!"
            )
        self.penalty_zone_width = kwargs.get("penalty_zone_width", 2)
        # comm/compute pipelining request of the sharded Poisson solve
        # (None = fft.DEFAULT_OVERLAP_CHUNKS; 1 = unpipelined control arm)
        self.overlap_chunks = kwargs.get("overlap_chunks", None)
        # opt-in bf16 wire format for the distributed spectral transposes
        # (halves all_to_all bytes, ~2e-3 solve rel err)
        self.comm_bf16 = bool(kwargs.get("comm_bf16", False))
        self.filter_setting_dict = kwargs.get(
            "filter_setting_dict", {"order": 2, "type": "multiplicative"}
        ) or {"order": 2, "type": "multiplicative"}
        known_kwargs = {
            "penalty_zone_width",
            "overlap_chunks",
            "comm_bf16",
            "filter_setting_dict",
        }
        unknown = set(kwargs) - known_kwargs
        if unknown:
            # a typo'd option (e.g. overlap_chunk=1) silently running the
            # defaults would poison benchmark control arms
            raise TypeError(
                f"Unknown keyword argument(s) {sorted(unknown)}; "
                f"supported: {sorted(known_kwargs)}"
            )
        if mesh is not None:
            check_grid_divisibility(self.grid_size, mesh)

        self._init_domain()
        self._init_fields()
        self._compile_step()

    def _init_domain(self):
        gx = self.grid_size_x
        self.y_range = self.x_range * self.grid_size_y / gx
        self.z_range = self.x_range * self.grid_size_z / gx
        self.dx = float(self.x_range / gx)
        shift = self.dx / 2.0
        axes = [
            np.linspace(shift, rng - shift, n)
            for rng, n in (
                (self.x_range, self.grid_size_x),
                (self.y_range, self.grid_size_y),
                (self.z_range, self.grid_size_z),
            )
        ]
        zg, yg, xg = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
        pos = np.stack([xg, yg, zg]).astype(np.dtype(self.real_t))
        self.position_field = shard_vector_field(jnp.asarray(pos), self.mesh)

    def _init_fields(self):
        zeros = lambda: shard_scalar_field(
            jnp.zeros(self.grid_size, dtype=self.real_t), self.mesh
        )
        vzeros = lambda: shard_vector_field(
            jnp.zeros((3, *self.grid_size), dtype=self.real_t), self.mesh
        )
        if self.flow_type == "passive_scalar":
            self.primary_field = zeros()
        else:
            self.primary_field = vzeros()
        self.velocity_field = vzeros()
        self.eul_grid_forcing_field = (
            vzeros() if self.flow_type == "navier_stokes_with_forcing" else None
        )
        if self.flow_type in ("navier_stokes", "navier_stokes_with_forcing"):
            self.stream_func_field = vzeros()
            self.unbounded_poisson_solver = UnboundedPoissonSolver3D(
                grid_size_z=self.grid_size_z,
                grid_size_y=self.grid_size_y,
                grid_size_x=self.grid_size_x,
                x_range=self.x_range,
                real_t=self.real_t,
                mesh=self.mesh,
                overlap_chunks=self.overlap_chunks,
                comm_bf16=self.comm_bf16,
            )

    @property
    def vorticity_field(self):
        return self.primary_field

    @vorticity_field.setter
    def vorticity_field(self, value):
        self.primary_field = value

    # alias for passive_vector flows (reference primary_vector_field)
    @property
    def primary_vector_field(self):
        return self.primary_field

    @primary_vector_field.setter
    def primary_vector_field(self, value):
        self.primary_field = value

    def _compile_step(self):
        cfg = dict(
            dx=self.dx,
            nu=self.kinematic_viscosity,
            flow_type=self.flow_type,
            with_free_stream=self.with_free_stream_flow,
            penalty_zone_width=self.penalty_zone_width,
            filter_order=(
                int(self.filter_setting_dict["order"])
                if self.filter_vorticity
                else 0
            ),
            filter_type=self.filter_setting_dict["type"],
            poisson_solver=getattr(self, "unbounded_poisson_solver", None),
        )

        def step(
            state: FlowState3D, dt, free_stream_velocity, poisson_greens
        ) -> FlowState3D:
            return flow_step_3d(
                state, dt, free_stream_velocity,
                poisson_greens=poisson_greens, **cfg,
            )

        self._step_fn = jax.jit(step)

        def step_l1(state, dt, free_stream_velocity, poisson_greens):
            """(state, velocity |u|_1 max) - the CFL quantity rides out of
            the step so fused loops need no extra velocity read for dt
            control."""
            return flow_step_3d(
                state, dt, free_stream_velocity,
                poisson_greens=poisson_greens,
                return_velocity_l1_max=True, **cfg,
            )

        self._step_l1_fn = jax.jit(step_l1)

        if self.flow_type == "navier_stokes_with_forcing":
            # variant with the full-field forcing-curl + reset skipped:
            # the fused rigid-FSI step applies the forcing as a static
            # sparse-window vorticity update BEFORE the flow step (the
            # forcing support of a fixed body covers a small fraction of
            # the domain), then steps plain navier_stokes
            cfg_nf = dict(cfg, flow_type="navier_stokes")

            def step_l1_noforcing(state, dt, free_stream_velocity,
                                  poisson_greens):
                return flow_step_3d(
                    state, dt, free_stream_velocity,
                    poisson_greens=poisson_greens,
                    return_velocity_l1_max=True, **cfg_nf,
                )

            self._step_l1_noforcing_fn = jax.jit(step_l1_noforcing)

    @property
    def _poisson_greens(self):
        """The Fourier Green's function, passed as a traced jit argument so
        the (2N)^3/2-sized array never becomes a compiled-in constant."""
        solver = getattr(self, "unbounded_poisson_solver", None)
        if solver is None:
            return jnp.zeros((), dtype=self.real_t)  # unused placeholder
        return solver.fourier_greens_times_dx_pow_dim

    def _get_state(self) -> FlowState3D:
        return FlowState3D(
            self.primary_field, self.velocity_field, self.eul_grid_forcing_field
        )

    def _set_state(self, state: FlowState3D):
        self.primary_field = state.primary_field
        self.velocity_field = state.velocity_field
        self.eul_grid_forcing_field = state.eul_grid_forcing_field

    # -- public API ----------------------------------------------------------

    def time_step(self, dt, free_stream_velocity=(0.0, 0.0, 0.0)):
        fsv = jnp.asarray(free_stream_velocity, dtype=self.real_t)
        self._set_state(
            self._step_fn(
                self._get_state(), self.real_t(dt), fsv, self._poisson_greens
            )
        )
        self.time += float(dt)

    def compute_stable_timestep(self, dt_prefac=1.0, precision="single") -> float:
        dt = compute_stable_timestep_3d(
            self.velocity_field,
            CFL=self.CFL,
            dx=self.dx,
            nu=self.kinematic_viscosity,
            tol=get_test_tol(precision),
        )
        return float(dt) * dt_prefac

    def diffusion_limited_timestep(self, dt_prefac=1.0) -> float:
        """Upper bound on every CFL/diffusion timestep this simulator can
        return (see UnboundedFlowSimulator2D.diffusion_limited_timestep)."""
        return float(
            dt_prefac * 0.9 * self.dx**2
            / (2 * self.grid_dim * self.kinematic_viscosity)
        )

    def get_max_vorticity(self) -> float:
        return float(jnp.max(self.vorticity_field))

    def compute_flow_velocity(self):
        """Recompute the velocity from the current vorticity (reference
        flow_simulators_mpi_3d.py:382-393 public path)."""
        field, velocity = compute_flow_velocity_3d(
            self.vorticity_field,
            jnp.zeros(3, self.real_t),
            dx=self.dx,
            penalty_zone_width=self.penalty_zone_width,
            poisson_solver=self.unbounded_poisson_solver,
            with_free_stream=False,
        )
        self.vorticity_field = field
        self.velocity_field = velocity

    def get_vorticity_divergence_l2_norm(self) -> float:
        """L2 norm of div(omega) (reference :451-469)."""
        div = divergence_3d(self.vorticity_field, 1.0 / self.dx)
        return float(jnp.linalg.norm(div) * self.dx**1.5)


# ---------------------------------------------------------------------------
# Functional core
# ---------------------------------------------------------------------------


def compute_flow_velocity_3d(
    vorticity, free_stream_velocity, *,
    dx, penalty_zone_width, poisson_solver, with_free_stream,
    poisson_greens=None,
    return_velocity_l1_max=False,
):
    """Wall-penalise vorticity -> vector Poisson -> curl -> free stream
    (reference :382-393). Returns (vorticity, velocity), plus the global
    ``max |u|_1`` of the new velocity (the CFL control quantity) when
    ``return_velocity_l1_max``."""
    vorticity = penalise_field_boundary_vector_3d(vorticity, penalty_zone_width)
    stream_func = poisson_solver.vector_field_solve(vorticity, poisson_greens)
    velocity = curl_3d(stream_func, jnp.asarray(0.5 / dx, vorticity.dtype))
    if with_free_stream:
        velocity = add_fixed_val(velocity, free_stream_velocity)
    if return_velocity_l1_max:
        l1_max = jnp.max(jnp.sum(jnp.abs(velocity), axis=0))
        return vorticity, velocity, l1_max
    return vorticity, velocity


def flow_step_3d(
    state: FlowState3D,
    dt,
    free_stream_velocity,
    *,
    dx,
    nu,
    flow_type,
    with_free_stream,
    penalty_zone_width,
    filter_order,
    filter_type,
    poisson_solver,
    poisson_greens=None,
    return_velocity_l1_max=False,
) -> FlowState3D:
    """One full 3D flow timestep (pure; jit/scan-safe). Ordering matches
    the reference dispatch (:327-413).

    ``return_velocity_l1_max=True`` returns ``(state, l1_max)`` where
    ``l1_max`` is the new velocity's global ``max |u|_1`` (the CFL control
    quantity, so the NEXT step's dt control needs no extra velocity read),
    or None for the passive flow types whose velocity never changes
    in-step."""
    field = state.primary_field
    velocity = state.velocity_field
    forcing = state.eul_grid_forcing_field
    real_t = field.dtype
    nu_dt_by_dx2 = jnp.asarray(nu * dt / dx / dx, real_t)
    dt_by_dx = jnp.asarray(dt / dx, real_t)
    l1_max = None

    if flow_type == "passive_scalar":
        field = advection_timestep_eno3_3d(field, velocity, dt_by_dx)
        field = diffusion_timestep_3d(field, nu_dt_by_dx2)
    elif flow_type == "passive_vector":
        field = advection_timestep_eno3_vector_3d(field, velocity, dt_by_dx)
        field = diffusion_timestep_vector_3d(field, nu_dt_by_dx2)
    else:
        if flow_type == "navier_stokes_with_forcing":
            field = update_vorticity_from_velocity_forcing_3d(
                field, forcing, jnp.asarray(dt / (2.0 * dx), real_t)
            )
        # rotational form transport (reference :395-413)
        pref = jnp.asarray(dt / (2.0 * dx), real_t)
        velocity_cross_vorticity = cross_product_3d(velocity, field)
        field = update_vorticity_from_velocity_forcing_3d(
            field, velocity_cross_vorticity, pref
        )
        field = diffusion_timestep_vector_3d(field, nu_dt_by_dx2)
        if filter_order > 0:
            field = laplacian_filter_vector_3d(
                field, filter_order, filter_type
            )
        res = compute_flow_velocity_3d(
            field,
            free_stream_velocity,
            dx=dx,
            penalty_zone_width=penalty_zone_width,
            poisson_solver=poisson_solver,
            with_free_stream=with_free_stream,
            poisson_greens=poisson_greens,
            return_velocity_l1_max=return_velocity_l1_max,
        )
        if return_velocity_l1_max:
            field, velocity, l1_max = res
        else:
            field, velocity = res
        if flow_type == "navier_stokes_with_forcing":
            forcing = jnp.zeros_like(forcing)

    new_state = FlowState3D(field, velocity, forcing)
    if return_velocity_l1_max:
        return new_state, l1_max
    return new_state


@functools.partial(jax.jit, static_argnames=("CFL", "dx", "nu", "tol"))
def compute_stable_timestep_3d(velocity_field, *, CFL, dx, nu, tol):
    velocity_mag = jnp.sum(jnp.abs(velocity_field), axis=0)
    dt_advection = CFL * dx / (jnp.max(velocity_mag) + tol)
    dt_diffusion = 0.9 * dx**2 / (2 * 3) / (nu + tol)
    return jnp.minimum(dt_advection, dt_diffusion)
