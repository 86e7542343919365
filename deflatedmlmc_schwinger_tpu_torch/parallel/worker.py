"""Start several ranks on this host and collect what they return.

    results = launch("package.module:function", nprocs, args=(...), device="cuda")

starts ``nprocs`` processes (the ``spawn`` start method: a forked child
cannot use CUDA once the parent has), gives them a free local port, lets
each join the process group (parallel/distributed.py ``initialize``) and
call ``function(*args, **kwargs)``, and returns the ranks' return values in
rank order. The values come back as files in a temporary directory. When a
rank fails, or ``timeout_s`` passes, every rank is killed and a RuntimeError
carries the failing rank's traceback.

The function is named by its import path, so it must live in a module:
``run_entry`` here is the one behind ``gateway.G302(devices=N)``.
"""

from __future__ import annotations

import importlib
import os
import pickle
import socket
import tempfile
import time
import traceback
from typing import Optional, Sequence

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resolve(target: str):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)


def _rank_main(rank: int, nprocs: int, port: int, target: str, args, kwargs,
               device: str, out_dir: str, group_timeout_s: float) -> None:
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nprocs),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        # all ranks are on this host: gloo needs no interface but loopback,
        # and a sealed machine may have no other that resolves
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)    # CPU ranks share the host's cores
        import torch.distributed as dist

        from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import initialize

        initialize(device=device, timeout_s=group_timeout_s)
        value = _resolve(target)(*args, **(kwargs or {}))
        with open(path + ".tmp", "wb") as f:
            pickle.dump(("ok", value), f)
        os.replace(path + ".tmp", path)
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
    except BaseException:
        with open(path + ".tmp", "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        os.replace(path + ".tmp", path)
        raise


def launch(target: str, nprocs: int, *, args: Sequence = (), kwargs: Optional[dict] = None,
           device: str = "cuda", timeout_s: float = 1800.0) -> list:
    """Run ``target`` ("module:function") on ``nprocs`` ranks of one process
    group on this host; returns their return values in rank order. The ranks
    inherit this process's environment and ``sys.path``; CPU ranks run one
    intra-op thread each."""
    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="dmlmc_ranks_") as out_dir:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, nprocs, port, target, tuple(args), kwargs, device,
                                   out_dir, timeout_s),
                             daemon=True)
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with code {procs[bad[0]].exitcode}"
                    break
                if time.monotonic() > deadline:
                    failed = f"the ranks did not end within {timeout_s:.0f} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        results, tracebacks = [], []
        for r, p in enumerate(procs):
            path = os.path.join(out_dir, f"rank{r}.pkl")
            status, value = "missing", None
            if os.path.exists(path):
                with open(path, "rb") as f:
                    status, value = pickle.load(f)
            if status == "error":
                tracebacks.append(f"--- rank {r} ---\n{value}")
            elif status == "missing" and failed is None:
                failed = f"rank {r} left no result (exit code {p.exitcode})"
            results.append(value)
        if failed is not None or tracebacks:
            raise RuntimeError(f"{target} on {nprocs} ranks: {failed or 'a rank failed'}\n"
                               + "\n".join(tracebacks))
        return results


def run_entry(name: str, device: str = "cuda"):
    """One rank's share of a gateway entry started with ``devices=N``. The
    result travels back as host numbers: the estimator's result without its
    timer and tensors, the phase seconds and the seconds of each phase spent
    in transport and in host reads, each phase's V-cycle and FGMRES graph
    calls (``graph_calls``, ``fgmres_graph_calls``), this rank's launches of K1-K3
    (``kernel_launches``) and of K4 (``block_launches``) during the entry,
    and
    ``ranks_agree``: whether every rank of the group got the same result
    (``ranks_differ_in`` names the keys that differ)."""
    import torch.distributed as dist

    from deflatedmlmc_schwinger_tpu_torch import gateway
    from deflatedmlmc_schwinger_tpu_torch.ops import block_kernels, stencil_kernels

    stencil_kernels.reset_launch_counts()
    block_kernels.reset_launch_counts()
    result = gateway.ENTRIES[name](device=device)
    out = {k: v for k, v in result.items() if k not in ("timer", "deflation")}
    if dist.is_initialized():
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, out)
        out["ranks_differ_in"] = sorted(k for k in out
                                        if any(r[k] != every[0][k] for r in every))
        out["ranks_agree"] = not out["ranks_differ_in"]
        out["backend"] = dist.get_backend()
    out["phase_seconds"] = dict(result["timer"].totals)
    out["transport_seconds"] = dict(result["timer"].transport)
    out["host_read_seconds"] = dict(result["timer"].host_read)
    graphs = result["timer"].graphs
    out["graph_calls"] = {k: dict(v["vcycle.graph"]) for k, v in graphs.items()}
    out["fgmres_graph_calls"] = {k: dict(v["fgmres.graph"]) for k, v in graphs.items()}
    out["kernel_launches"] = stencil_kernels.launch_counts()
    out["yardstick_launches"] = stencil_kernels.yardstick_counts()
    out["block_launches"] = block_kernels.launch_counts()
    return out
