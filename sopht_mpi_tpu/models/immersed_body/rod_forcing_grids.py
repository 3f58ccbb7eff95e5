"""Forcing grids for Cosserat rods.

Counterparts of the rod forcing-grid classes the reference imports from the
external ``sopht`` package (``CosseratRodElementCentricForcingGrid``,
``CosseratRodSurfaceForcingGrid``; reference usage
/root/reference/examples/2d_examples/FlowPastRodCase/flow_past_rod.py:11-14
and .../3d_examples/FlowPastRodCase/flow_past_rod_case.py:10,:131-132).

Functional design: all marker kinematics are pure jnp expressions on the
rod state pytree, so the full FSI interaction jits. The per-point element
index/angle bookkeeping of the surface grid is precomputed as static
arrays (radii are time-invariant), leaving only vectorized gathers at
call time - the vectorized replacement for the reference's per-element
Python loops.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from sopht_mpi_tpu.models.immersed_body.forcing_grids import (
    ImmersedBodyForcingGrid,
)


class CosseratRodElementCentricForcingGrid(ImmersedBodyForcingGrid):
    """2D grid with one marker per rod element (element centers).

    Forces are transferred back to the two adjacent nodes with equal
    weights; no torques (the marker sits on the centerline).
    """

    grid_dim = 2

    def __init__(self, cosserat_rod, **kwargs):
        self.rod = cosserat_rod
        self.num_lag_nodes = cosserat_rod.n_elems

    @property
    def position_field(self):
        return self.compute_lag_grid_position_field()

    # pure state-based kernels (jit/scan-safe; used by the fused on-device
    # FSI loop, models/fsi.py)

    def lag_positions(self, rod_state):
        pos = rod_state.position
        return 0.5 * (pos[:2, 1:] + pos[:2, :-1])

    def lag_velocities(self, rod_state):
        vel = rod_state.velocity
        return 0.5 * (vel[:2, 1:] + vel[:2, :-1])

    def body_loads(self, rod_state, lag_grid_forcing_field):
        n = lag_grid_forcing_field.shape[1]
        dtype = lag_grid_forcing_field.dtype
        forces = jnp.zeros((3, n + 1), dtype)
        half = -0.5 * lag_grid_forcing_field  # force ON body = -lag forcing
        forces = forces.at[:2, :-1].add(half)
        forces = forces.at[:2, 1:].add(half)
        torques = jnp.zeros((3, n), dtype)
        return forces, torques

    # stateful wrappers (reference API surface)

    def compute_lag_grid_position_field(self):
        return self.lag_positions(self.rod.state)

    def compute_lag_grid_velocity_field(self):
        return self.lag_velocities(self.rod.state)

    def transfer_forcing_from_grid_to_body(self, lag_grid_forcing_field):
        return self.body_loads(self.rod.state, lag_grid_forcing_field)

    def get_maximum_lagrangian_grid_spacing(self):
        return float(jnp.max(self.rod.lengths))


class CosseratRodEdgeForcingGrid(ImmersedBodyForcingGrid):
    """2D grid with markers at rod element centers AND both lateral edges
    (centers ± radius along the in-plane normal): ``3 * n_elems`` markers.

    Counterpart of the serial ``sopht`` package's
    ``CosseratRodEdgeForcingGrid`` (imported but unused by the reference's
    examples — the reference's 2D rod case uses the element-centric grid,
    /root/reference/examples/2d_examples/FlowPastRodCase/flow_past_rod.py:
    11-14). Resolving the rod's finite thickness lets the flow exert a
    torque: edge-marker forces contribute moments about the element
    centers, which the element-centric grid cannot represent.

    Marker layout (same ordering as upstream): ``[:n]`` element centers,
    ``[n:2n]`` "+normal" edge, ``[2n:]`` "−normal" edge, with the in-plane
    normal ``n = ẑ × t`` from the element tangent ``t``. Edge-marker
    velocities include the element's rotation
    (``v = v_elem + ω_lab × arm``); force transfer splits each element's
    accumulated force between adjacent nodes and maps edge moments
    ``arm × F`` into the material frame.
    """

    grid_dim = 2

    def __init__(self, cosserat_rod, **kwargs):
        self.rod = cosserat_rod
        n_elems = cosserat_rod.n_elems
        self.num_lag_nodes = 3 * n_elems
        dtype = np.dtype(cosserat_rod.state.position.dtype)
        self._radius = jnp.asarray(
            np.asarray(cosserat_rod.params.radius).astype(dtype)
        )
        lengths = np.asarray(cosserat_rod.params.rest_lengths)
        self._max_spacing = float(lengths.max())

    # -- marker kinematics ----------------------------------------------------

    def _frames(self, rod_state):
        """(centers (2,n), vels (2,n), omega_z (n,), arm (2,n)) with
        ``arm = radius * (ẑ × t̂)`` the "+edge" moment arm in-plane."""
        pos = rod_state.position
        vel = rod_state.velocity
        centers = 0.5 * (pos[:2, 1:] + pos[:2, :-1])
        vels = 0.5 * (vel[:2, 1:] + vel[:2, :-1])
        tangent = pos[:2, 1:] - pos[:2, :-1]
        tangent = tangent / jnp.linalg.norm(tangent, axis=0, keepdims=True)
        # in-plane unit normal: z x t = (-t_y, t_x)
        normal = jnp.stack([-tangent[1], tangent[0]])
        arm = self._radius * normal
        # lab-frame angular velocity, z component (the only in-plane one)
        omega_z = jnp.einsum(
            "jn,jn->n", rod_state.director[:, 2], rod_state.omega, precision=jax.lax.Precision.HIGHEST
        )
        return centers, vels, omega_z, arm

    @property
    def position_field(self):
        return self.compute_lag_grid_position_field()

    # pure state-based kernels (jit/scan-safe; used by the fused on-device
    # FSI loop, models/fsi.py)

    def lag_positions(self, rod_state):
        centers, _, _, arm = self._frames(rod_state)
        return jnp.concatenate(
            [centers, centers + arm, centers - arm], axis=1
        )

    def lag_velocities(self, rod_state):
        centers, vels, omega_z, arm = self._frames(rod_state)
        # omega_z ẑ × arm = omega_z * (-arm_y, arm_x)
        rot = omega_z * jnp.stack([-arm[1], arm[0]])
        return jnp.concatenate([vels, vels + rot, vels - rot], axis=1)

    def body_loads(self, rod_state, lag_grid_forcing_field):
        n = rod_state.omega.shape[1]
        dtype = lag_grid_forcing_field.dtype
        body_force = -lag_grid_forcing_field  # Newton's third law
        f_center = body_force[:, :n]
        f_plus = body_force[:, n : 2 * n]
        f_minus = body_force[:, 2 * n :]
        elem_force = f_center + f_plus + f_minus
        forces = jnp.zeros((3, n + 1), dtype)
        forces = forces.at[:2, :-1].add(0.5 * elem_force)
        forces = forces.at[:2, 1:].add(0.5 * elem_force)
        # edge moments about element centers: arm x F (z component only
        # in-plane); "-edge" arm is -arm
        _, _, _, arm = self._frames(rod_state)
        df = f_plus - f_minus
        torque_z = arm[0] * df[1] - arm[1] * df[0]
        elem_torque_lab = jnp.zeros((3, n), dtype).at[2].set(torque_z)
        torques = jnp.einsum(
            "ijn,jn->in", rod_state.director, elem_torque_lab,
            precision=jax.lax.Precision.HIGHEST,
        )
        return forces, torques

    # stateful wrappers (reference API surface)

    def compute_lag_grid_position_field(self):
        return self.lag_positions(self.rod.state)

    def compute_lag_grid_velocity_field(self):
        return self.lag_velocities(self.rod.state)

    def transfer_forcing_from_grid_to_body(self, lag_grid_forcing_field):
        return self.body_loads(self.rod.state, lag_grid_forcing_field)

    def get_maximum_lagrangian_grid_spacing(self):
        return self._max_spacing


class CosseratRodSurfaceForcingGrid(ImmersedBodyForcingGrid):
    """3D grid with markers on the rod's lateral surface: one ring per
    element, with the ring point count scaled by the element radius
    relative to the largest element
    (``surface_grid_density_for_largest_element`` points on the largest
    ring; reference usage flow_past_rod_case.py:131-132).

    Marker kinematics include the element's rigid rotation
    (``v = v_elem + omega_lab x arm``); force transfer splits each
    marker's force between the adjacent nodes and accumulates the
    material-frame torque about the element center.
    """

    grid_dim = 3

    def __init__(
        self,
        cosserat_rod,
        surface_grid_density_for_largest_element: int,
        with_cap: bool = False,
        **kwargs,
    ):
        self.rod = cosserat_rod
        radii = np.asarray(cosserat_rod.params.radius)
        n_elems = cosserat_rod.n_elems
        r_max = float(radii.max())
        density = int(surface_grid_density_for_largest_element)

        elem_idx = []
        angles = []
        for k in range(n_elems):
            n_theta = max(1, int(np.ceil(density * radii[k] / r_max)))
            th = np.linspace(0.0, 2.0 * np.pi, n_theta, endpoint=False)
            elem_idx.extend([k] * n_theta)
            angles.extend(th.tolist())
        self._elem_idx = jnp.asarray(np.asarray(elem_idx, np.int32))
        self._np_elem_idx = np.asarray(elem_idx, np.int64)
        dtype = np.dtype(cosserat_rod.state.position.dtype)
        angles = np.asarray(angles, dtype)
        self._cos_t = jnp.asarray(np.cos(angles))
        self._sin_t = jnp.asarray(np.sin(angles))
        self._radius = jnp.asarray(radii[self._np_elem_idx].astype(dtype))
        self.num_lag_nodes = len(elem_idx)

        ring_counts = np.bincount(self._np_elem_idx, minlength=n_elems)
        lengths = np.asarray(cosserat_rod.params.rest_lengths)
        self._max_spacing = float(
            max(
                lengths.max(),
                (2.0 * np.pi * radii / np.maximum(ring_counts, 1)).max(),
            )
        )

    # -- marker kinematics ----------------------------------------------------

    def _element_frames(self, state=None):
        """(centers, velocities, omega_lab, d1, d2) gathered per marker."""
        if state is None:
            state = self.rod.state
        idx = self._elem_idx
        centers = 0.5 * (state.position[:, 1:] + state.position[:, :-1])
        vels = 0.5 * (state.velocity[:, 1:] + state.velocity[:, :-1])
        # omega in lab frame: w_lab = Q^T w_material
        omega_lab = jnp.einsum(
            "jin,jn->in", state.director, state.omega, precision=jax.lax.Precision.HIGHEST
        )
        d1 = state.director[0]  # (3, n): material axis 1 in lab frame
        d2 = state.director[1]
        return (
            centers[:, idx],
            vels[:, idx],
            omega_lab[:, idx],
            d1[:, idx],
            d2[:, idx],
        )

    def _moment_arms(self, state=None):
        _, _, _, d1, d2 = self._element_frames(state)
        return self._radius * (self._cos_t * d1 + self._sin_t * d2)

    @property
    def position_field(self):
        return self.compute_lag_grid_position_field()

    # pure state-based kernels (jit/scan-safe; used by the fused on-device
    # FSI loop, models/fsi.py)

    def lag_positions(self, rod_state):
        centers, _, _, d1, d2 = self._element_frames(rod_state)
        arm = self._radius * (self._cos_t * d1 + self._sin_t * d2)
        return centers + arm

    def lag_velocities(self, rod_state):
        centers, vels, omega_lab, d1, d2 = self._element_frames(rod_state)
        arm = self._radius * (self._cos_t * d1 + self._sin_t * d2)
        return vels + jnp.cross(omega_lab, arm, axis=0)

    def body_loads(self, rod_state, lag_grid_forcing_field):
        n = rod_state.omega.shape[1]
        dtype = lag_grid_forcing_field.dtype
        body_force = -lag_grid_forcing_field  # Newton's third law
        # accumulate per-element force, split half-half to adjacent nodes
        elem_force = (
            jnp.zeros((3, n), dtype).at[:, self._elem_idx].add(body_force)
        )
        forces = jnp.zeros((3, n + 1), dtype)
        forces = forces.at[:, :-1].add(0.5 * elem_force)
        forces = forces.at[:, 1:].add(0.5 * elem_force)
        # material-frame torque about element centers
        arm = self._moment_arms(rod_state)
        torque_lab = jnp.cross(arm, body_force, axis=0)
        elem_torque_lab = (
            jnp.zeros((3, n), dtype).at[:, self._elem_idx].add(torque_lab)
        )
        torques = jnp.einsum(
            "ijn,jn->in", rod_state.director, elem_torque_lab,
            precision=jax.lax.Precision.HIGHEST,
        )
        return forces, torques

    # stateful wrappers (reference API surface)

    def compute_lag_grid_position_field(self):
        return self.lag_positions(self.rod.state)

    def compute_lag_grid_velocity_field(self):
        return self.lag_velocities(self.rod.state)

    def transfer_forcing_from_grid_to_body(self, lag_grid_forcing_field):
        return self.body_loads(self.rod.state, lag_grid_forcing_field)

    def get_maximum_lagrangian_grid_spacing(self):
        return self._max_spacing
