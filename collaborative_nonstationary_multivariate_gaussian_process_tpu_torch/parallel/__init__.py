from . import mesh, sharded_mcmc, sharded_smc  # noqa: F401
from .mesh import (  # noqa: F401
    global_batch_from_local,
    initialize_distributed,
    make_mesh,
    make_pod_mesh,
    process_local_slice,
)
from .sharded_smc import run_smc_sharded  # noqa: F401
