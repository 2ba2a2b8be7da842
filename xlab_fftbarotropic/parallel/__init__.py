"""Distributed execution: device meshes, distributed FFT, sharded models.

The reference has no parallelism at all (SURVEY.md §2); everything here is
new capability: slab-decomposed distributed 2-D real FFT over a
jax.sharding.Mesh (dfft.py) and the fully sharded RK4 stepper (model.py).
"""

from .dfft import irfft2_local, make_fft_pair, rfft2_local  # noqa: F401
from .multihost import initialize as initialize_multihost  # noqa: F401
from .multihost import is_primary  # noqa: F401
from .model import (  # noqa: F401
    AXIS,
    axis_size,
    make_mesh2d,
    ShardedBarotropicModel,
    ShardedShallowWaterModel,
    ShardedTracerModel,
    make_mesh,
    table_specs,
)
