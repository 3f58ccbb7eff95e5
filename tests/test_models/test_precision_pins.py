"""Every float32 contraction on the rod, rigid-body and IBM paths is pinned
to ``Precision.HIGHEST``: on a GPU an f32 dot given no precision may run
in TF32 (a 10-bit mantissa), and the rod and body states would drift at
~1e-3 relative. Each case traces one call site and checks that every
``dot_general`` in its jaxpr carries HIGHEST."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sopht_mpi_tpu.models import (
    CircularCylinderForcingGrid,
    CosseratRod,
    CosseratRodEdgeForcingGrid,
    CosseratRodSurfaceForcingGrid,
    Cylinder,
    Sphere,
    SphereForcingGrid,
)
from sopht_mpi_tpu.models.elastica import rod as rod_mod
from sopht_mpi_tpu.models.elastica.forcing import GeneralConstraint
from sopht_mpi_tpu.models.elastica.rotations import relative_rotation_vectors
from sopht_mpi_tpu.models.rigid_body import (
    _rotate_matrix,
    rigid_body_acceleration,
)
from sopht_mpi_tpu.ops.ibm import (
    axis_delta_weight_matrices,
    nearest_grid_index_and_support,
)

F32 = jnp.float32


def _dot_precisions(jaxpr):
    """The precision of every dot_general in ``jaxpr`` and its sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out.extend(_dot_precisions(sub))
    return out


def _rod():
    return CosseratRod.straight_rod(
        6, np.array([0.2, 0.3, 0.4]), np.array([0.0, 1.0, 0.0]),
        np.array([0.0, 0.0, 1.0]), base_length=0.3, base_radius=0.02,
        density=1e3, youngs_modulus=1e5, shear_modulus=1e5 / 1.5,
    )


def _rod_f32():
    rod = _rod()
    cast = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, F32)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, t)
    return rod, cast(rod.state), cast(rod.params)


def _site(name):
    """(function, example args) for one pinned call site."""
    rod, state, params = _rod_f32()
    n = state.director.shape[-1]
    if name == "rod-strains":
        return rod_mod.compute_strains, (state, params)
    if name == "rod-accelerations":
        return rod_mod.compute_accelerations, (
            state, params, jnp.zeros((3, n + 1), F32), jnp.zeros((3, n), F32))
    if name == "rotations":
        return relative_rotation_vectors, (state.director,)
    if name == "general-constraint":
        bc = GeneralConstraint(np.zeros(3), np.eye(3), [True] * 3,
                               [False, True, True])
        return bc.constrain_rates, (state,)
    if name == "rigid-rotate":
        return _rotate_matrix, (jnp.eye(3, dtype=F32),
                                jnp.ones(3, F32), F32(0.1))
    if name == "rigid-acceleration":
        body = Sphere(center=np.array([0.5, 0.5, 0.5]), radius=0.1,
                      dtype=F32, density=1.0)
        return (lambda s: rigid_body_acceleration(
            s, jnp.ones(3, F32), jnp.ones(3, F32), body.mass,
            body.inertia_body), (body.state,))
    if name == "cylinder-grid":
        cyl = Cylinder(center=(0.4, 0.5), radius=0.08, dtype=F32)
        grid = CircularCylinderForcingGrid(rigid_body=cyl,
                                           num_forcing_points=16)
        return grid._rotated_points, (cyl.state,)
    if name == "sphere-grid":
        sph = Sphere(center=np.array([0.5, 0.5, 0.5]), radius=0.1, dtype=F32)
        grid = SphereForcingGrid(rigid_body=sph,
                                 num_forcing_points_along_equator=8)
        return grid._rotated_points, (sph.state,)
    if name == "rod-edge-grid":
        grid = CosseratRodEdgeForcingGrid(cosserat_rod=rod)
        forcing = jnp.ones((2, grid.num_lag_nodes), F32)
        return (lambda s: (grid._frames(s), grid.body_loads(s, forcing)),
                (state,))
    if name == "rod-surface-grid":
        grid = CosseratRodSurfaceForcingGrid(
            cosserat_rod=rod, surface_grid_density_for_largest_element=4)
        forcing = jnp.ones((3, grid.num_lag_nodes), F32)
        return (lambda s: (grid._element_frames(s),
                           grid.body_loads(s, forcing)), (state,))
    if name == "ibm-weight-matrices":
        dx = 1.0 / 32
        pos = jnp.asarray(np.random.default_rng(0).uniform(
            0.3, 0.6, (3, 20)), F32)

        def build(p):
            _, idx, disp = nearest_grid_index_and_support(p, dx, dx / 2, 2)
            return axis_delta_weight_matrices(idx - 8, disp, dx,
                                              (16, 16, 16))
        return build, (pos,)
    raise ValueError(name)


SITES = ["rod-strains", "rod-accelerations", "rotations",
         "general-constraint", "rigid-rotate", "rigid-acceleration",
         "cylinder-grid", "sphere-grid", "rod-edge-grid", "rod-surface-grid",
         "ibm-weight-matrices"]


@pytest.mark.parametrize("site", SITES)
def test_contractions_lower_with_highest_precision(site):
    fn, args = _site(site)
    precisions = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precisions, "no contraction traced at this call site"
    highest = jax.lax.Precision.HIGHEST
    for p in precisions:
        assert p is not None and all(q == highest for q in p), precisions
