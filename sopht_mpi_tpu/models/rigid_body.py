"""Rigid bodies (JAX counterpart of the PyElastica rigid bodies the
reference consumes: ``elastica.Cylinder``, ``elastica.Sphere``; see
/root/reference/examples/2d_examples/FlowPastCylinderCase/
flow_past_cylinder.py:34-43, 3d .../flow_past_sphere_case.py).

State is a small pytree. The reference examples keep rigid bodies fixed,
but the reference interactor exists precisely to hand ``body_flow_forces/
torques (3, 1)`` to PyElastica's rigid-body stepper
(/root/reference/sopht_mpi/simulator/immersed_body/rigid_body/
rigid_body_flow_interaction_mpi.py:10-64), so two-way coupling is part of
the capability surface: :func:`rigid_body_position_verlet_step` is the
PositionVerlet-equivalent symplectic integrator consuming those loads
(half kinematic step, full dynamic step, half kinematic step - the same
splitting PyElastica's ``PositionVerlet`` applies to rods and rigid
bodies alike). Bodies constructed with a ``density`` carry mass/inertia;
density-less bodies stay purely kinematic (fixed/prescribed), exactly the
reference examples' usage.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def _mm(a, b):
    """Full-float32 matrix product (no TF32 on GPUs)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


class RigidBodyState(NamedTuple):
    """Rigid body kinematic state (pytree).

    position/velocity/angular velocity are in the global frame, shape (3,)
    (2D bodies use the x-y components and z rotation).
    ``director`` is the rotation matrix body->global, shape (3, 3).
    """

    position: jax.Array
    velocity: jax.Array
    omega: jax.Array
    director: jax.Array

    @staticmethod
    def create(position, velocity=None, omega=None, director=None, dtype=None):
        position = jnp.asarray(position, dtype=dtype)
        dtype = position.dtype
        if position.shape[0] == 2:
            position = jnp.concatenate([position, jnp.zeros(1, dtype)])
        return RigidBodyState(
            position=position,
            velocity=(
                jnp.zeros(3, dtype) if velocity is None
                else jnp.asarray(velocity, dtype)
            ),
            omega=(
                jnp.zeros(3, dtype) if omega is None
                else jnp.asarray(omega, dtype)
            ),
            director=(
                jnp.eye(3, dtype=dtype) if director is None
                else jnp.asarray(director, dtype)
            ),
        )


def _rotate_matrix(director, omega, dt):
    """Advance the body->global director by a rotation about the GLOBAL
    angular velocity: ``Q <- exp(hat(omega) dt) Q`` (exact integral of
    ``dQ/dt = hat(omega) Q`` for constant omega; Rodrigues form,
    branch-free at |omega| dt -> 0)."""
    phi = omega * dt
    theta2 = jnp.sum(phi * phi)
    theta = jnp.sqrt(theta2)
    safe = theta > 1e-10
    theta_s = jnp.where(safe, theta, 1.0)
    sinc = jnp.where(safe, jnp.sin(theta_s) / theta_s, 1.0 - theta2 / 6.0)
    cosc = jnp.where(
        safe, (1.0 - jnp.cos(theta_s)) / (theta_s * theta_s),
        0.5 - theta2 / 24.0,
    )
    px = jnp.array(
        [
            [0.0, -phi[2], phi[1]],
            [phi[2], 0.0, -phi[0]],
            [-phi[1], phi[0], 0.0],
        ],
        dtype=director.dtype,
    )
    rot = (
        jnp.eye(3, dtype=director.dtype) + sinc * px + cosc * _mm(px, px)
    )
    return _mm(rot, director)


def rigid_body_acceleration(
    state: RigidBodyState, force, torque, mass, inertia_body
):
    """Linear and angular acceleration from global-frame loads.

    Euler's equation evaluated in the global frame with the body-frame
    (principal) inertia ``inertia_body`` (shape (3,) diagonal):
    ``alpha = I_g^{-1} (T - omega x (I_g omega))``, ``I_g = Q I_b Q^T``.
    For isotropic bodies (sphere; 2D cylinder spinning about its axis) the
    gyroscopic term vanishes identically.
    """
    q = state.director
    inertia_body = jnp.asarray(inertia_body, q.dtype)
    i_omega = _mm(q, inertia_body * _mm(q.T, state.omega))
    gyro = jnp.cross(state.omega, i_omega)
    alpha = _mm(
        q, _mm(q.T, jnp.asarray(torque, q.dtype) - gyro) / inertia_body
    )
    acc = jnp.asarray(force, q.dtype) / mass
    return acc, alpha


def rigid_body_position_verlet_step(
    state: RigidBodyState, dt, force, torque, mass, inertia_body
) -> RigidBodyState:
    """One symplectic position-Verlet step of free rigid-body dynamics
    under constant external loads (the splitting PyElastica's
    ``PositionVerlet`` applies per update: half kinematic, full dynamic,
    half kinematic). ``force``/``torque`` are global-frame, shape (3,)
    or (3, 1) as the interactor produces them.

    Intended consumers: ``body_flow_forces/body_flow_torques`` from
    :class:`...immersed_body.interaction.RigidBodyFlowInteraction`
    (reference contract rigid_body_flow_interaction_mpi.py:10-64), plus
    any user loads (gravity/buoyancy).
    """
    force = jnp.reshape(jnp.asarray(force), (3,))
    torque = jnp.reshape(jnp.asarray(torque), (3,))
    half = 0.5 * dt
    # first kinematic half step
    pos = state.position + half * state.velocity
    director = _rotate_matrix(state.director, state.omega, half)
    state_half = state._replace(position=pos, director=director)
    # dynamic step
    acc, alpha = rigid_body_acceleration(
        state_half, force, torque, mass, inertia_body
    )
    vel = state.velocity + dt * acc
    omega = state.omega + dt * alpha
    # second kinematic half step
    pos = pos + half * vel
    director = _rotate_matrix(director, omega, half)
    return RigidBodyState(
        position=pos, velocity=vel, omega=omega, director=director
    )


class Cylinder:
    """2D circular cylinder (axis out of plane).

    Mirrors the usage of ``elastica.Cylinder`` in the reference 2D examples
    (flow_past_cylinder.py:34-43). ``density`` (per unit span, like
    PyElastica's 3D cylinder with unit length) enables dynamics:
    ``mass = rho pi r^2``, axial inertia ``m r^2 / 2`` (in-plane entries
    use the thin-disk values ``m r^2 / 4``)."""

    def __init__(self, center, radius, dtype=jnp.float32, density=None):
        self.radius = float(radius)
        self.state = RigidBodyState.create(np.asarray(center), dtype=dtype)
        self.density = density
        if density is not None:
            self.mass = float(density) * np.pi * self.radius**2
            i_axis = 0.5 * self.mass * self.radius**2
            self.inertia_body = np.array([0.5 * i_axis, 0.5 * i_axis, i_axis])

    n_elems = 1


class Sphere:
    """Rigid sphere (reference 3D flow-past-sphere case). ``density``
    enables dynamics: ``mass = rho 4/3 pi r^3``, isotropic inertia
    ``2/5 m r^2`` (PyElastica ``Sphere`` values)."""

    def __init__(self, center, radius, dtype=jnp.float32, density=None):
        self.radius = float(radius)
        self.state = RigidBodyState.create(np.asarray(center), dtype=dtype)
        self.density = density
        if density is not None:
            self.mass = float(density) * 4.0 / 3.0 * np.pi * self.radius**3
            self.inertia_body = np.full(3, 0.4 * self.mass * self.radius**2)

    n_elems = 1
