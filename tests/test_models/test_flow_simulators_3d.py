

def test_simulator_rejects_unknown_kwargs():
    """A typo'd option (overlap_chunk=...) must raise instead
    of silently running the defaults - it would poison benchmark control
    arms."""
    import pytest

    from sopht_mpi_tpu.models import (
        UnboundedFlowSimulator2D,
        UnboundedFlowSimulator3D,
    )

    with pytest.raises(TypeError, match="overlap_chunk"):
        UnboundedFlowSimulator3D(
            grid_size=(8, 8, 8),
            x_range=1.0,
            kinematic_viscosity=1e-3,
            overlap_chunk=1,
        )
    with pytest.raises(TypeError, match="penalty_zone_widht"):
        UnboundedFlowSimulator2D(
            grid_size=(8, 8),
            x_range=1.0,
            kinematic_viscosity=1e-3,
            penalty_zone_widht=2,
        )
