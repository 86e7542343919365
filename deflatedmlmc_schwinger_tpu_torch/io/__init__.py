from deflatedmlmc_schwinger_tpu_torch.io.gauge import generate_operator  # noqa: F401
from deflatedmlmc_schwinger_tpu_torch.io.matio import load_operator  # noqa: F401
from deflatedmlmc_schwinger_tpu_torch.io.stencil import (  # noqa: F401
    csr_from_stencil,
    stencil_from_csr,
)
