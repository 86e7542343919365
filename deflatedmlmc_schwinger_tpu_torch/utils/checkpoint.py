"""Checkpoints of the hierarchy and of an estimator's sampling state, in
the JAX package's file formats (counterpart of
deflatedmlmc_schwinger_tpu/utils/checkpoint.py): a file written by either
package loads in the other.

The hierarchy npz holds, per level i, the operator as real/imaginary planes
``op{i}_re``/``op{i}_im`` (stencil coefficients, block-stencil blocks or a
dense matrix), the prolongator blocks ``P{i}_re``/``P{i}_im``, the coarsest
inverse, and a JSON ``__meta__`` with the level kinds, offsets, shifts and
smoother roots. The estimator state is a JSON file of running moments, the
next global sample index and the accumulated solver iterations, per name
("hutchinson", or "level{i}" for MLMC). Probes are keyed by their global
sample index (trace/probes.py), so a run resumed from (moments, next_index)
continues the same sample stream.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Optional, Tuple

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
from deflatedmlmc_schwinger_tpu_torch.trace.stats import RunningMoments


def _roots(meta: Mapping, name: str) -> Optional[Tuple[Tuple[complex, ...], ...]]:
    if name not in meta:
        return None
    return tuple(tuple(complex(re, im) for re, im in lev) for lev in meta[name])


def hierarchy_from_numpy(arrays: Mapping[str, np.ndarray], meta, device,
                         dtype: torch.dtype) -> Hierarchy:
    """Build a Hierarchy from the npz arrays and the decoded ``__meta__``
    (a dict with 'levels', or the bare level list of older checkpoints);
    grouped-band packing is redone as the JAX loader does (on the CPU; on a
    CUDA device kernel K4 reads the block-sparse layout, rebuilt here)."""
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


def save_hierarchy(hier: Hierarchy, path: str) -> None:
    """Write the hierarchy as a compressed npz (module docstring)."""
    arrays: Dict[str, np.ndarray] = {}

    def put(name: str, t: torch.Tensor) -> None:
        z = t.detach().cpu().numpy()
        arrays[f"{name}_re"] = np.ascontiguousarray(z.real)
        arrays[f"{name}_im"] = np.ascontiguousarray(z.imag)

    meta: List[Dict] = []
    for i, lev in enumerate(hier.levels):
        entry: Dict = {"perm_shift": int(lev.perm_shift)}
        op = lev.op
        if isinstance(op, StencilOperator):
            entry.update(kind="stencil", nx=op.nx, nt=op.nt)
            put(f"op{i}", op.coeffs)
        elif isinstance(op, BlockStencilOperator):
            entry.update(kind="block_stencil", offsets=list(op.offsets))
            put(f"op{i}", op.blocks)
        else:
            entry["kind"] = "dense"
            put(f"op{i}", op.mat)
        entry["has_P"] = lev.P is not None
        if lev.P is not None:
            put(f"P{i}", lev.P.blocks)
        meta.append(entry)
    put("coarsest_inv", hier.coarsest_inv)
    extra: Dict = {"levels": meta}
    for name in ("poly_roots", "poly_roots_extra"):
        val = getattr(hier, name)
        if val is not None:
            extra[name] = [[[complex(t).real, complex(t).imag] for t in lev_roots]
                           for lev_roots in val]
    np.savez_compressed(path, __meta__=json.dumps(extra), **arrays)


def load_hierarchy(path: str, device, dtype: torch.dtype) -> Hierarchy:
    """Read a hierarchy npz written by ``save_hierarchy`` of either
    package."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return hierarchy_from_numpy(arrays, meta, device, dtype)


@dataclasses.dataclass
class EstimatorState:
    """Resumable sampling state: running moments and the next global sample
    index per name, and the accumulated solver iterations, so that a resumed
    run reports the complexity of all its samples."""

    moments: Dict[str, RunningMoments]
    next_index: Dict[str, int]
    iters: Dict[str, int] = dataclasses.field(default_factory=dict)

    def save(self, path: str) -> None:
        payload: Dict = {
            name: dict(count=m.count, mean_re=m.mean.real, mean_im=m.mean.imag,
                       m2=m.m2, next_index=self.next_index.get(name, 0))
            for name, m in self.moments.items()
        }
        payload["__iters__"] = {k: int(v) for k, v in self.iters.items()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)        # atomic: a reader never sees half a file

    @classmethod
    def load(cls, path: str) -> "EstimatorState":
        with open(path) as f:
            payload = json.load(f)
        iters = {k: int(v) for k, v in payload.pop("__iters__", {}).items()}
        moments = {name: RunningMoments(count=int(d["count"]),
                                        mean=complex(d["mean_re"], d["mean_im"]),
                                        m2=float(d["m2"]))
                   for name, d in payload.items()}
        next_index = {name: int(d["next_index"]) for name, d in payload.items()}
        return cls(moments=moments, next_index=next_index, iters=iters)

    @classmethod
    def load_or_empty(cls, path: Optional[str]) -> "EstimatorState":
        if path and os.path.exists(path):
            return cls.load(path)
        return cls(moments={}, next_index={})


def setup_or_load_hierarchy(op, cfg, checkpoint_dir: Optional[str], log) -> Hierarchy:
    """The estimators' hierarchy: read from ``checkpoint_dir``/hierarchy.npz
    when that file exists, else built by mg/setup.py setup_hierarchy and,
    with a checkpoint directory, saved there."""
    from deflatedmlmc_schwinger_tpu_torch.mg.setup import setup_hierarchy

    path = os.path.join(checkpoint_dir, "hierarchy.npz") if checkpoint_dir else None
    if path and os.path.exists(path):
        log(f"resumed hierarchy from {path}")
        return load_hierarchy(path, op.device, op.dtype)
    hier = setup_hierarchy(op, cfg)
    if path:
        save_hierarchy(hier, path)
    return hier
