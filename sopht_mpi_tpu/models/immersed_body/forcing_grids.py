"""Forcing grids: Lagrangian marker sets attached to immersed bodies.

Counterpart of the forcing-grid classes the reference imports from the
external ``sopht`` package (``ImmersedBodyForcingGrid``,
``CircularCylinderForcingGrid``, ``SphereForcingGrid``; see
/root/reference/examples/2d_examples/FlowPastCylinderCase/
flow_past_cylinder.py:9, 3d .../flow_past_sphere_case.py) plus the in-tree
``EmptyForcingGrid`` (/root/reference/sopht_mpi/simulator/immersed_body/
immersed_body_forcing_grid.py:4-26).

Functional design: a forcing grid computes marker positions/velocities from
the current body state each call (the reference mutates cached arrays), and
``transfer_forcing_from_grid_to_body`` returns the body forces/torques
(force on body = -sum of the Lagrangian penalty forcing, Newton's third
law - the reference's sopht grids carry the same minus sign).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


class ImmersedBodyForcingGrid:
    """Abstract forcing grid interface."""

    grid_dim: int
    num_lag_nodes: int

    def compute_lag_grid_position_field(self):
        raise NotImplementedError

    def compute_lag_grid_velocity_field(self):
        raise NotImplementedError

    def transfer_forcing_from_grid_to_body(self, lag_grid_forcing_field):
        """Return (body_flow_forces (3, ...), body_flow_torques (3, ...))."""
        raise NotImplementedError

    def get_maximum_lagrangian_grid_spacing(self) -> float:
        raise NotImplementedError


class EmptyForcingGrid(ImmersedBodyForcingGrid):
    """Zero-node grid (API parity with the reference's non-master-rank
    stub; markers are replicated here so it is rarely needed)."""

    def __init__(self, grid_dim):
        self.grid_dim = grid_dim
        self.num_lag_nodes = 0

    def compute_lag_grid_position_field(self):
        return jnp.zeros((self.grid_dim, 0))

    def compute_lag_grid_velocity_field(self):
        return jnp.zeros((self.grid_dim, 0))

    def transfer_forcing_from_grid_to_body(self, lag_grid_forcing_field):
        return jnp.zeros((3, 1)), jnp.zeros((3, 1))

    def get_maximum_lagrangian_grid_spacing(self):
        return 0.0


class CircularCylinderForcingGrid(ImmersedBodyForcingGrid):
    """Markers on the perimeter of a 2D circular cylinder."""

    grid_dim = 2

    def __init__(self, rigid_body, num_forcing_points: int):
        self.body = rigid_body
        self.num_lag_nodes = num_forcing_points
        theta = np.linspace(
            0.0, 2.0 * np.pi, num_forcing_points, endpoint=False
        )
        self._local_points = jnp.asarray(
            rigid_body.radius * np.stack([np.cos(theta), np.sin(theta)]),
            dtype=self.body.state.position.dtype,
        )

    def compute_lag_grid_position_field(self):
        return self.lag_positions(self.body.state)

    def compute_lag_grid_velocity_field(self):
        return self.lag_velocities(self.body.state)

    # state-parametrized API (same trio as the rod forcing grids) so the
    # fused FSI builders can track an in-trace dynamic body state
    def lag_positions(self, state):
        r = self._rotated_points(state)
        return state.position[:2, None] + r

    def lag_velocities(self, state):
        # v + omega x r (z-rotation only in 2D)
        omega_z = state.omega[2]
        r = self._rotated_points(state)
        rot = jnp.stack([-omega_z * r[1], omega_z * r[0]])
        return state.velocity[:2, None] + rot

    def body_loads(self, state, lag_grid_forcing_field):
        """(3, 1) global-frame force/torque about the COM from the
        Lagrangian penalty forcing (Newton's third law minus sign)."""
        forces = jnp.zeros((3, 1), dtype=lag_grid_forcing_field.dtype)
        forces = forces.at[:2, 0].set(
            -jnp.sum(lag_grid_forcing_field, axis=1)
        )
        r = self._rotated_points(state)
        torque_z = -jnp.sum(
            r[0] * lag_grid_forcing_field[1]
            - r[1] * lag_grid_forcing_field[0]
        )
        torques = jnp.zeros((3, 1), dtype=lag_grid_forcing_field.dtype)
        torques = torques.at[2, 0].set(torque_z)
        return forces, torques

    def _rotated_points(self, state):
        """Body-frame marker offsets rotated into the global frame
        (z-rotation is the only one that moves in-plane points)."""
        return jnp.matmul(
            state.director[:2, :2], self._local_points, precision=jax.lax.Precision.HIGHEST
        ).astype(
            self._local_points.dtype
        )

    def transfer_forcing_from_grid_to_body(self, lag_grid_forcing_field):
        return self.body_loads(self.body.state, lag_grid_forcing_field)

    def get_maximum_lagrangian_grid_spacing(self):
        return 2.0 * np.pi * self.body.radius / self.num_lag_nodes


class SphereForcingGrid(ImmersedBodyForcingGrid):
    """Near-uniform markers on a sphere surface, parameterised by the
    number of points along the equator (rows at constant polar angle with
    azimuthal counts proportional to sin(theta))."""

    grid_dim = 3

    def __init__(self, rigid_body, num_forcing_points_along_equator: int):
        self.body = rigid_body
        n_eq = num_forcing_points_along_equator
        polar = np.linspace(0, np.pi, n_eq // 2 + 1)[1:-1]  # exclude poles
        pts = [np.array([0.0, 0.0, 1.0]), np.array([0.0, 0.0, -1.0])]
        for theta in polar:
            n_az = max(1, int(round(n_eq * np.sin(theta))))
            phi = np.linspace(0, 2 * np.pi, n_az, endpoint=False)
            ring = np.stack(
                [
                    np.sin(theta) * np.cos(phi),
                    np.sin(theta) * np.sin(phi),
                    np.full(n_az, np.cos(theta)),
                ],
                axis=0,
            )
            pts.append(ring.T if ring.ndim == 1 else ring.T)
        unit = np.concatenate(
            [p[None] if p.ndim == 1 else p for p in pts], axis=0
        ).T  # (3, N)
        self.num_lag_nodes = unit.shape[1]
        self._local_points = jnp.asarray(
            rigid_body.radius * unit, dtype=self.body.state.position.dtype
        )
        self._max_spacing = 2.0 * np.pi * rigid_body.radius / n_eq

    def compute_lag_grid_position_field(self):
        return self.lag_positions(self.body.state)

    def compute_lag_grid_velocity_field(self):
        return self.lag_velocities(self.body.state)

    # state-parametrized API (same trio as the rod forcing grids) so the
    # fused FSI builders can track an in-trace dynamic body state
    def lag_positions(self, state):
        return state.position[:, None] + self._rotated_points(state)

    def lag_velocities(self, state):
        omega = state.omega
        r = self._rotated_points(state)
        rot = jnp.stack(
            [
                omega[1] * r[2] - omega[2] * r[1],
                omega[2] * r[0] - omega[0] * r[2],
                omega[0] * r[1] - omega[1] * r[0],
            ]
        )
        return state.velocity[:, None] + rot

    def body_loads(self, state, lag_grid_forcing_field):
        forces = -jnp.sum(lag_grid_forcing_field, axis=1, keepdims=True)
        r = self._rotated_points(state)
        f = lag_grid_forcing_field
        torques = -jnp.stack(
            [
                jnp.sum(r[1] * f[2] - r[2] * f[1], keepdims=True),
                jnp.sum(r[2] * f[0] - r[0] * f[2], keepdims=True),
                jnp.sum(r[0] * f[1] - r[1] * f[0], keepdims=True),
            ]
        )
        return forces, torques

    def _rotated_points(self, state):
        return jnp.matmul(
            state.director, self._local_points, precision=jax.lax.Precision.HIGHEST
        ).astype(
            self._local_points.dtype
        )

    def transfer_forcing_from_grid_to_body(self, lag_grid_forcing_field):
        return self.body_loads(self.body.state, lag_grid_forcing_field)

    def get_maximum_lagrangian_grid_spacing(self):
        return self._max_spacing
