"""Multi-host bootstrap helpers (single-process behavior + the
Compute_dims-equivalent process-grid factoring)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sopht_mpi_tpu.parallel import (
    auto_mesh,
    compute_mesh_dims,
    initialize_distributed,
    shard_scalar_field,
)


def assert_collectives_are_all_to_all(hlo: str, doubled_elems: int):
    """Shared HLO collective pin: all-to-all transposes present, and no
    all-gather producing anything near the doubled-spectrum size
    (``doubled_elems``), which would silently de-scale the memory story."""
    import re

    assert "all-to-all" in hlo
    for m in re.finditer(
        r"all-gather\(?[^=]*=\s*\S*?([cf]\d+)\[([\d,]*)\]", hlo
    ):
        dims = [int(d) for d in m.group(2).split(",") if d]
        elems = 1
        for d in dims:
            elems *= d
        assert elems < doubled_elems, f"all-gather of {m.group(0)[:80]}"


def test_initialize_distributed_single_host_noop(monkeypatch):
    from sopht_mpi_tpu.parallel.distributed import _DIST_ENV_HINTS

    for k in _DIST_ENV_HINTS:
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False


def test_compute_mesh_dims_slab_first():
    # slab divides -> slab wins (the reference's default rank_distribution)
    assert compute_mesh_dims(3, 8, (32, 16, 48)) == (8, 1)
    assert compute_mesh_dims(2, 4, (16, 16)) == (4, 1)
    # no grid -> slab directly
    assert compute_mesh_dims(3, 6) == (6, 1)


def test_compute_mesh_dims_pencil_fallback():
    # leading axis too small for a slab -> balanced pencil
    assert compute_mesh_dims(3, 8, (4, 16, 32)) == (4, 2)
    assert compute_mesh_dims(3, 8, (2, 8, 32)) == (2, 4)
    # nothing divides -> error (the reference raises RuntimeError too,
    # mpi_utils_2d.py:52-58)
    with pytest.raises(RuntimeError):
        compute_mesh_dims(3, 8, (3, 5, 32))


def test_auto_mesh_shards_and_computes():
    mesh = auto_mesh(3, (16, 16, 16))
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {"z": 8, "y": 1}
    f = shard_scalar_field(jnp.ones((16, 16, 16)), mesh)
    assert float(jnp.sum(f)) == 16**3


def test_sharded_convolve_lowers_to_all_to_all():
    """Regression guard on the compiled collective structure: the
    distributed free-space convolve must lower to all-to-all pencil
    transposes - not to all-gathers of the full doubled spectrum (which
    would silently de-scale the memory story)."""
    from sopht_mpi_tpu.parallel import create_mesh, distributed_rfftn
    from sopht_mpi_tpu.parallel.fft import distributed_free_space_convolve

    n = 16
    mesh = create_mesh(3, (4, 2))
    rng = np.random.default_rng(0)
    rhs = shard_scalar_field(
        jnp.asarray(rng.standard_normal((n, n, n)), jnp.float32), mesh
    )
    kernel = shard_scalar_field(
        jnp.asarray(rng.standard_normal((2 * n, 2 * n, 2 * n)), jnp.float32),
        mesh,
    )
    g = jnp.real(distributed_rfftn(kernel, mesh))

    fn = jax.jit(
        lambda r, gg: distributed_free_space_convolve(r, gg, mesh)
    )
    hlo = fn.lower(rhs, g).compile().as_text()
    assert_collectives_are_all_to_all(hlo, (2 * n) ** 3)


def test_fused_fsi_step_lowers_to_all_to_all():
    """The WHOLE fused FSI step (CFL dt + IBM + rotational NS with
    unbounded Poisson) over a pencil mesh must keep the collective
    structure of its parts: all-to-all FFT transposes, and no all-gather
    anywhere near the full doubled spectrum (the first real pod run must
    hold no surprises - VERDICT round-2 next-step 9)."""
    from __graft_entry__ import _build_fsi_case
    from sopht_mpi_tpu.parallel import create_mesh

    n = 16
    mesh = create_mesh(3, (4, 2))
    step, (carry,) = _build_fsi_case(grid_size=(n, n, n), mesh=mesh)
    hlo = jax.jit(step).lower(carry).compile().as_text()
    assert_collectives_are_all_to_all(hlo, (2 * n) ** 3)


def test_fused_multi_body_step_lowers_to_all_to_all():
    """Same collective pin for the mixed soft/rigid fused step (rod +
    fixed sphere) over a pencil mesh."""
    import re
    import sys
    import os

    ex3d = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "examples", "3d",
    )
    sys.path.insert(0, ex3d)
    from rod_and_sphere import rod_and_sphere_case  # noqa: F401  (import check)
    from sopht_mpi_tpu.models import (
        FixedRigidBody,
        RigidBodyFlowInteraction,
        Sphere,
        SphereForcingGrid,
        UnboundedFlowSimulator3D,
        build_multi_body_fsi_step,
        init_multi_body_fsi_carry,
    )
    from sopht_mpi_tpu.parallel import create_mesh

    n = 16
    mesh = create_mesh(3, (4, 2))
    flow_sim = UnboundedFlowSimulator3D(
        grid_size=(n, n, n), x_range=1.0, kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        real_t=np.float32, mesh=mesh,
    )
    sphere = Sphere(
        center=np.array([0.5, 0.5, 0.5]), radius=0.15, dtype=np.float32
    )
    grid = SphereForcingGrid(rigid_body=sphere,
                             num_forcing_points_along_equator=8)
    interactor = RigidBodyFlowInteraction(
        flow_sim=flow_sim, rigid_body=sphere, forcing_grid=grid,
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0,
    )
    bodies = (FixedRigidBody(interactor),)
    step = build_multi_body_fsi_step(flow_sim, bodies)
    carry = init_multi_body_fsi_carry(flow_sim, bodies)
    hlo = jax.jit(step).lower(carry).compile().as_text()
    assert_collectives_are_all_to_all(hlo, (2 * n) ** 3)


def test_sharded_convolve_2d_pencil_lowers_to_all_to_all():
    """Same collective-structure guard for the 2D PENCIL path (px > 1;
    exceeds the reference's slab-only 2D solver): the x-axis gather/split
    pair plus the y transposes must be all-to-alls, with no all-gather of
    the doubled spectrum."""
    from sopht_mpi_tpu.parallel import create_mesh, distributed_rfftn
    from sopht_mpi_tpu.parallel.fft import distributed_free_space_convolve

    ny, nx = 32, 16
    mesh = create_mesh(2, (4, 2))
    rng = np.random.default_rng(1)
    rhs = shard_scalar_field(
        jnp.asarray(rng.standard_normal((ny, nx)), jnp.float32), mesh
    )
    kernel = shard_scalar_field(
        jnp.asarray(rng.standard_normal((2 * ny, 2 * nx)), jnp.float32), mesh
    )
    g = jnp.real(distributed_rfftn(kernel, mesh))

    fn = jax.jit(
        lambda r, gg: distributed_free_space_convolve(r, gg, mesh)
    )
    hlo = fn.lower(rhs, g).compile().as_text()
    assert_collectives_are_all_to_all(hlo, (2 * ny) * (2 * nx))
