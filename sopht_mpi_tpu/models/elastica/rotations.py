"""SO(3) exp/log maps for director kinematics (batched, jit-safe).

The reference delegates rod rotations to PyElastica's numba kernels
(``_rotations.py`` in the external ``elastica`` package; consumed via
``ea.CosseratRod`` in /root/reference/examples/2d_examples/FlowPastRodCase/
flow_past_rod.py:74-84). Here they are closed-form Rodrigues formulas on
batched arrays - branch-free (series fallbacks via ``jnp.where``) so they
jit and differentiate cleanly on the device.

Conventions: a director collection ``Q`` has shape (3, 3, n); row ``i`` of
``Q[..., k]`` is the lab-frame direction of material axis ``d_i`` of
element ``k``, so ``Q u_lab -> u_material``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_SMALL = 1e-10


def _skew_apply(phi, u):
    """Batched cross product ``phi x u`` for (3, n) arrays."""
    return jnp.stack(
        [
            phi[1] * u[2] - phi[2] * u[1],
            phi[2] * u[0] - phi[0] * u[2],
            phi[0] * u[1] - phi[1] * u[0],
        ]
    )


def exp_rotate(director_collection, rotation_vector):
    """Apply ``Q <- exp(-hat(phi)) Q`` per element.

    This is the exact integral of the director kinematic equation
    ``dQ/dt = -hat(omega_local) Q`` over a step with constant local
    angular velocity (``phi = omega_local * dt``).

    :param director_collection: (3, 3, n)
    :param rotation_vector: (3, n) material-frame rotation vector.
    """
    phi = rotation_vector
    theta2 = jnp.sum(phi * phi, axis=0)  # (n,)
    theta = jnp.sqrt(theta2)
    # sin(t)/t and (1-cos t)/t^2 with series fallbacks at t -> 0
    safe = theta > _SMALL
    theta_s = jnp.where(safe, theta, 1.0)
    sinc = jnp.where(safe, jnp.sin(theta_s) / theta_s, 1.0 - theta2 / 6.0)
    cosc = jnp.where(
        safe, (1.0 - jnp.cos(theta_s)) / (theta_s * theta_s), 0.5 - theta2 / 24.0
    )

    # Q <- R Q with R = exp(-hat(phi)) = I - sinc*hat(phi) + cosc*hat(phi)^2.
    # Columns of Q transform as vectors: (R Q)[:, j] = R Q[:, j]. (Applying
    # R to the ROWS would compute Q exp(+hat(phi)) instead, which inverts
    # the sign of the curvature-rate/angular-velocity relation and makes
    # bending anti-conservative.)
    def rot_col(c):
        pxc = _skew_apply(phi, c)
        pxpxc = _skew_apply(phi, pxc)
        return c - sinc * pxc + cosc * pxpxc

    return jnp.stack(
        [rot_col(director_collection[:, j]) for j in range(3)], axis=1
    )


def log_rotation_vector(rot):
    """Rotation vector of a batch of rotation matrices, shape (3, 3, n) ->
    (3, n): ``rot = exp(hat(phi))``."""
    trace = rot[0, 0] + rot[1, 1] + rot[2, 2]
    cos_theta = jnp.clip(0.5 * (trace - 1.0), -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    # skew part: rot - rot^T = 2 sin(theta) hat(u)
    v = jnp.stack(
        [
            rot[2, 1] - rot[1, 2],
            rot[0, 2] - rot[2, 0],
            rot[1, 0] - rot[0, 1],
        ]
    )
    sin_theta = jnp.sin(theta)
    safe = sin_theta > _SMALL
    scale = jnp.where(
        safe,
        theta / jnp.where(safe, 2.0 * sin_theta, 1.0),
        0.5 + theta * theta / 12.0,
    )
    return scale * v


def relative_rotation_vectors(director_collection):
    """Rotation vectors between consecutive element frames.

    For elements k and k+1 returns ``phi_k`` with
    ``Q_{k+1} Q_k^T = exp(hat(phi_k))``, shape (3, n-1). The material-frame
    curvature is ``kappa = -phi / rest_voronoi_length`` (see rod.py).
    """
    q_next = director_collection[..., 1:]  # (3, 3, n-1)
    q_prev = director_collection[..., :-1]
    # R = Q_{k+1} Q_k^T
    rot = jnp.einsum("ijn,kjn->ikn", q_next, q_prev, precision=jax.lax.Precision.HIGHEST)
    return log_rotation_vector(rot)
