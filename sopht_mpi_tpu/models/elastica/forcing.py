"""Boundary conditions, external forcings and damping for Cosserat rods.

JAX counterparts of the PyElastica modules the reference consumes:
``ea.OneEndFixedBC``, ``ea.GravityForces``, ``ea.AnalyticalLinearDamper``
(flow_past_rod.py:88-103) and sopht's ``FlowForces`` coupling class
(flow_past_rod.py:138-141). Each is a small stateless object with pure
methods on the rod state pytree, so the composed step jits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sopht_mpi_tpu.models.elastica.rod import (
    CosseratRodState,
    compute_geometry,
)


class OneEndFixedBC:
    """Clamp one end: fixed node position and element director
    (reference usage flow_past_rod.py:88-90)."""

    def __init__(self, fixed_position, fixed_director, node_idx=0, elem_idx=0):
        self.fixed_position = jnp.asarray(fixed_position)
        self.fixed_director = jnp.asarray(fixed_director)
        self.node_idx = node_idx
        self.elem_idx = elem_idx

    def constrain_values(self, state: CosseratRodState) -> CosseratRodState:
        return state._replace(
            position=state.position.at[:, self.node_idx].set(
                self.fixed_position
            ),
            director=state.director.at[:, :, self.elem_idx].set(
                self.fixed_director
            ),
        )

    def constrain_rates(self, state: CosseratRodState) -> CosseratRodState:
        return state._replace(
            velocity=state.velocity.at[:, self.node_idx].set(0.0),
            omega=state.omega.at[:, self.elem_idx].set(0.0),
        )


class FreeBC:
    """No constraint (free rod)."""

    def constrain_values(self, state):
        return state

    def constrain_rates(self, state):
        return state


class GeneralConstraint:
    """Selective end constraint (PyElastica's ``GeneralConstraint``;
    reference usage flow_past_freely_rotating_rod_case.py:84-91 fixes the
    end translation fully but frees axial rotation).

    :param translational_constraint_selector: (3,) bool, lab frame - which
        node velocity/position components are fixed.
    :param rotational_constraint_selector: (3,) bool, LAB frame (PyElastica
        semantics) - which lab-frame angular-velocity components are
        zeroed; e.g. ``[False, True, True]`` on a rod along x frees only
        the axial spin.
    """

    def __init__(
        self,
        fixed_position,
        fixed_director,
        translational_constraint_selector,
        rotational_constraint_selector,
        node_idx=0,
        elem_idx=0,
    ):
        self.fixed_position = jnp.asarray(fixed_position)
        self.t_sel = jnp.asarray(
            np.asarray(translational_constraint_selector, bool)
        )
        self.r_sel = jnp.asarray(
            np.asarray(rotational_constraint_selector, bool)
        )
        self.node_idx = node_idx
        self.elem_idx = elem_idx

    def constrain_values(self, state: CosseratRodState) -> CosseratRodState:
        i = self.node_idx
        pos = state.position.at[:, i].set(
            jnp.where(self.t_sel, self.fixed_position, state.position[:, i])
        )
        return state._replace(position=pos)

    def constrain_rates(self, state: CosseratRodState) -> CosseratRodState:
        i, k = self.node_idx, self.elem_idx
        vel = state.velocity.at[:, i].set(
            jnp.where(self.t_sel, 0.0, state.velocity[:, i])
        )
        # rotational selector acts in the LAB frame: rotate the element's
        # angular velocity out, mask, rotate back
        q = state.director[:, :, k]  # (3, 3): rows are material axes
        hi = jax.lax.Precision.HIGHEST
        w_lab = jnp.matmul(q.T, state.omega[:, k], precision=hi)
        w_lab = jnp.where(self.r_sel, 0.0, w_lab)
        omega = state.omega.at[:, k].set(jnp.matmul(q, w_lab, precision=hi))
        return state._replace(velocity=vel, omega=omega)


class GravityForces:
    """Uniform gravitational force on nodes: ``F_i = m_i g``.

    Jit-pure: evaluated inside the compiled rod step.
    """

    requires_host = False

    def __init__(self, acc_gravity):
        self.acc_gravity = jnp.asarray(np.asarray(acc_gravity, np.float64))

    def compute(self, state: CosseratRodState, params, time):
        dtype = state.position.dtype
        forces = self.acc_gravity.astype(dtype)[:, None] * params.mass[None, :]
        torques = jnp.zeros((3, params.rest_lengths.shape[0]), dtype)
        return forces, torques


class EndpointForces:
    """Forces on the two end nodes with optional linear ramp-up
    (PyElastica's ``EndpointForces``; used by the Timoshenko validation).
    Jit-pure."""

    requires_host = False

    def __init__(self, start_force, end_force, ramp_up_time=0.0):
        self.start_force = jnp.asarray(np.asarray(start_force, np.float64))
        self.end_force = jnp.asarray(np.asarray(end_force, np.float64))
        self.ramp_up_time = float(ramp_up_time)

    def compute(self, state: CosseratRodState, params, time):
        n = params.rest_lengths.shape[0]
        dtype = state.position.dtype
        if self.ramp_up_time > 0:
            factor = jnp.minimum(1.0, time / self.ramp_up_time).astype(dtype)
        else:
            factor = jnp.asarray(1.0, dtype)
        forces = jnp.zeros((3, n + 1), dtype)
        forces = forces.at[:, 0].add(factor * self.start_force.astype(dtype))
        forces = forces.at[:, -1].add(factor * self.end_force.astype(dtype))
        return forces, jnp.zeros((3, n), dtype)


class FlowForces:
    """Two-way FSI coupling forcing (sopht's ``FlowForces``; reference
    usage flow_past_rod.py:138-141): before each rod substep the
    interactor's current penalty body forces/torques are refreshed and
    passed into the compiled rod step as traced buffers (``requires_host``
    - the flow interaction depends on flow-side Python state)."""

    requires_host = True

    def __init__(self, cosserat_rod_flow_interactor):
        self.interactor = cosserat_rod_flow_interactor

    def compute_host(self, rod, time=0.0):
        self.interactor.compute_flow_forces_and_torques()
        dtype = rod.state.position.dtype
        return (
            self.interactor.body_flow_forces.astype(dtype),
            self.interactor.body_flow_torques.astype(dtype),
        )


class AnalyticalLinearDamper:
    """Exponential velocity damping (PyElastica's analytical damper;
    reference usage flow_past_rod.py:98-103):
    ``v <- v exp(-c dt)``, ``w <- w exp(-c dt)^e`` with element
    dilatation ``e``."""

    def __init__(self, damping_constant, time_step):
        self.damping_constant = float(damping_constant)
        self.time_step = float(time_step)
        self._factor = float(np.exp(-damping_constant * time_step))

    def dampen_rates(self, state: CosseratRodState, params) -> CosseratRodState:
        _, _, dilatation, _ = compute_geometry(state, params)
        return state._replace(
            velocity=state.velocity * self._factor,
            omega=state.omega * self._factor**dilatation,
        )
