from deflatedmlmc_schwinger_tpu_torch.ops.dirac import (  # noqa: F401
    TAPS,
    StencilOperator,
    gamma3,
    shift_rows_down,
    shift_rows_up,
    stencil_matvec_host,
)
