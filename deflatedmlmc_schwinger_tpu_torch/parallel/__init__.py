from deflatedmlmc_schwinger_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
    replicate,
)
from deflatedmlmc_schwinger_tpu_torch.parallel.halo import (  # noqa: F401
    halo_matvec,
    shard_coeffs,
)
from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import (  # noqa: F401
    allgather_moments,
    initialize,
    psum_moments,
)
from deflatedmlmc_schwinger_tpu_torch.parallel.sharded_solve import (  # noqa: F401
    ShardedMGSolver,
)
