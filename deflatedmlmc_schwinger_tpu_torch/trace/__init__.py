from deflatedmlmc_schwinger_tpu_torch.trace.hutchinson import hutchinson  # noqa: F401
from deflatedmlmc_schwinger_tpu_torch.trace.mlmc import mlmc  # noqa: F401
