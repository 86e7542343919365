from deflatedmlmc_schwinger_tpu_torch.mg.cycle import MGSolver  # noqa: F401
from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import Hierarchy  # noqa: F401
from deflatedmlmc_schwinger_tpu_torch.mg.setup import (  # noqa: F401
    check_quality,
    setup_hierarchy,
)
