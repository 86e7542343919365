"""Example entry points (counterpart of deflatedmlmc_schwinger_tpu/examples.py)."""

from __future__ import annotations

import time
from typing import Dict

from deflatedmlmc_schwinger_tpu_torch.config import TraceConfig, pin_full_precision_matmuls
from deflatedmlmc_schwinger_tpu_torch.io import load_operator
from deflatedmlmc_schwinger_tpu_torch.reporting import print_post_results, result_to_json


def EXAMPLE_001(cfg: TraceConfig, *, device) -> Dict:
    """Compute tr(A^{-1}) with deflated Hutchinson on ``device``."""
    from deflatedmlmc_schwinger_tpu_torch.trace import hutchinson

    pin_full_precision_matmuls()
    print("\n----------------------------------------------------------")
    print("Example 01 : computing tr(A^{-1}) with deflated Hutchinson")
    print("----------------------------------------------------------\n")
    op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                          dtype=cfg.complex_dtype(), device=device)
    start = time.time()
    result = hutchinson(op, cfg)
    print(f"Total Hutchinson time = {time.time()-start} seconds\n")
    print_post_results(cfg, result, "hutchinson")
    print(result_to_json(cfg, result, "hutchinson"))
    return result


def EXAMPLE_002(cfg: TraceConfig, *, device) -> Dict:
    """Compute tr(A^{-1}) with deflated MG-MLMC on ``device``."""
    from deflatedmlmc_schwinger_tpu_torch.trace import mlmc

    pin_full_precision_matmuls()
    print("\n-------------------------------------------")
    print("Example 02 : computing tr(A^{-1}) with MLMC")
    print("-------------------------------------------\n")
    op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                          dtype=cfg.complex_dtype(), device=device)
    start = time.time()
    result = mlmc(op, cfg)
    print(f"Total MLMC time = {time.time()-start} seconds")
    print_post_results(cfg, result, "mlmc")
    print(result_to_json(cfg, result, "mlmc"))
    return result
