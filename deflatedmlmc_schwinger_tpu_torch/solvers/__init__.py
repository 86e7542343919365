from deflatedmlmc_schwinger_tpu_torch.solvers.fgmres import (  # noqa: F401
    FGMRESResult,
    fgmres,
)
