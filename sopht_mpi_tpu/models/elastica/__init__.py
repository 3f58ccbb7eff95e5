"""JAX Cosserat rod dynamics (PyElastica-equivalent feature set).

The reference performs structural dynamics with the external PyElastica
package on the master MPI rank only (SURVEY.md section 2.4); here the rod
is a JAX pytree stepped by pure functions, so flow + coupling + structure
jit together on the device.
"""

from sopht_mpi_tpu.models.elastica.rod import (
    CosseratRod,
    CosseratRodParams,
    CosseratRodState,
    compute_accelerations,
    compute_geometry,
    compute_strains,
    difference_kernel,
    kinematic_step,
    make_straight_rod_arrays,
    quadrature_kernel,
)
from sopht_mpi_tpu.models.elastica.rotations import (
    exp_rotate,
    log_rotation_vector,
    relative_rotation_vectors,
)
from sopht_mpi_tpu.models.elastica.forcing import (
    AnalyticalLinearDamper,
    EndpointForces,
    FlowForces,
    FreeBC,
    GeneralConstraint,
    GravityForces,
    OneEndFixedBC,
)
from sopht_mpi_tpu.models.elastica.stepper import (
    BaseSystemCollection,
    PositionVerlet,
    extend_stepper_interface,
)
