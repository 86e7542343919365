"""Hierarchy checkpoints in the JAX package's npz format (counterpart of
the loading half of deflatedmlmc_schwinger_tpu/utils/checkpoint.py).

The npz written by the JAX ``save_hierarchy`` holds, per level i, the
operator as real/imaginary planes ``op{i}_re``/``op{i}_im`` (stencil
coefficients, block-stencil blocks or a dense matrix), the prolongator
blocks ``P{i}_re``/``P{i}_im``, the coarsest inverse, and a JSON
``__meta__`` with the level kinds, offsets, shifts and smoother roots.
Loading it gives the port the exact hierarchy the JAX package built. Saving
and estimator-state resume wait for their slice.
"""

from __future__ import annotations

import json
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import (
    BlockProlongator,
    BlockStencilOperator,
    DenseOperator,
    Hierarchy,
    MGLevel,
    pack_grouped,
)
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import StencilOperator


def _roots(meta: Mapping, name: str) -> Optional[Tuple[Tuple[complex, ...], ...]]:
    if name not in meta:
        return None
    return tuple(tuple(complex(re, im) for re, im in lev) for lev in meta[name])


def hierarchy_from_numpy(arrays: Mapping[str, np.ndarray], meta, device,
                         dtype: torch.dtype) -> Hierarchy:
    """Build a Hierarchy from the npz arrays and the decoded ``__meta__``
    (a dict with 'levels', or the bare level list of older checkpoints);
    grouped-band packing is redone as the JAX loader does."""
    levels_meta = meta["levels"] if isinstance(meta, dict) else meta
    extra: Dict = meta if isinstance(meta, dict) else {}

    def get(name: str) -> torch.Tensor:
        z = (np.asarray(arrays[f"{name}_re"], np.float64)
             + 1j * np.asarray(arrays[f"{name}_im"], np.float64))
        return torch.from_numpy(np.ascontiguousarray(z)).to(device=device, dtype=dtype)

    levels = []
    for i, entry in enumerate(levels_meta):
        if entry["kind"] == "stencil":
            op = StencilOperator(get(f"op{i}"), int(entry["nx"]), int(entry["nt"]))
        elif entry["kind"] == "block_stencil":
            op = pack_grouped(BlockStencilOperator(
                blocks=get(f"op{i}"), offsets=tuple(entry["offsets"])))
        elif entry["kind"] == "dense":
            op = DenseOperator(mat=get(f"op{i}"))
        else:
            raise ValueError(f"unknown level kind {entry['kind']!r}")
        P = BlockProlongator(blocks=get(f"P{i}")) if entry["has_P"] else None
        levels.append(MGLevel(op=op, P=P, perm_shift=int(entry["perm_shift"])))
    return Hierarchy(levels=levels, coarsest_inv=get("coarsest_inv"),
                     poly_roots=_roots(extra, "poly_roots"),
                     poly_roots_extra=_roots(extra, "poly_roots_extra"))


def load_hierarchy(path: str, device, dtype: torch.dtype) -> Hierarchy:
    """Read a hierarchy npz written by the JAX package's save_hierarchy."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return hierarchy_from_numpy(arrays, meta, device, dtype)
