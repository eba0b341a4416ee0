"""Multi-process initialization (``rehrseg_tpu.parallel.distributed``) over
``torch.distributed``: one process per card.

Call :func:`init_distributed` once at program start, before any CUDA work;
the CLI does. It reads the JAX package's variables, ``REHRSEG_COORDINATOR``
(host:port), ``REHRSEG_NUM_PROCESSES`` and ``REHRSEG_PROCESS_ID``, and
torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` where those are not set (they take the place of the TPU pod
runtime's hints). The backend is ``nccl`` on the cards, ``gloo`` where
``REHRSEG_PLATFORM=cpu`` asks for the CPU; an NCCL init that fails raises
and does not fall back to gloo.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def cpu_requested() -> bool:
    """``REHRSEG_PLATFORM=cpu``: the explicit request for the CPU (and
    gloo); any other value, or none, names the card."""
    return (os.environ.get("REHRSEG_PLATFORM") or "").lower() == "cpu"


def _env_processes() -> int:
    for var in ("REHRSEG_NUM_PROCESSES", "WORLD_SIZE"):
        if os.environ.get(var):
            return int(os.environ[var])
    return 1


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     backend: str | None = None,
                     timeout_s: float = 1800.0,
                     cards_per_process: int = 1) -> bool:
    """Form the process group when the run has more than one process.

    Returns True if it formed one; False, doing nothing, for one process or
    when a group already exists, so it is safe to call unconditionally.
    backend: None picks ``gloo`` under ``REHRSEG_PLATFORM=cpu`` and
    ``nccl`` otherwise; a caller may name one (``gloo`` on CUDA tensors is
    for a card shared by several processes, which NCCL refuses). With
    ``nccl`` the process's first card (``LOCAL_RANK``, else the process
    index modulo the processes the visible cards hold, times
    ``cards_per_process``: a spatially sharded run drives that many cards
    a process) is made current before the group forms."""
    if dist.is_available() and dist.is_initialized():
        return False
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("REHRSEG_COORDINATOR")
        if coordinator_address is None and env.get("MASTER_ADDR"):
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_processes()
    if process_id is None:
        for var in ("REHRSEG_PROCESS_ID", "RANK"):
            if env.get(var):
                process_id = int(env[var])
                break
    if num_processes < 2:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError(
            f"{num_processes} processes but no coordinator address or "
            f"process id: set REHRSEG_COORDINATOR and REHRSEG_PROCESS_ID "
            f"(or launch with torchrun)")
    if backend is None:
        backend = "gloo" if cpu_requested() else "nccl"
    if backend == "nccl":
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("backend nccl: no CUDA device is visible "
                               "(REHRSEG_PLATFORM=cpu selects gloo)")
        per = int(cards_per_process)
        local = int(env.get("LOCAL_RANK",
                            process_id % max(n_cards // per, 1))) * per
        if local + per > n_cards:
            raise RuntimeError(f"local rank {local // per} with {per} "
                               f"card(s) a process but {n_cards} visible "
                               f"card(s)")
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def assert_pod_consistency() -> None:
    """Fail when the environment names this process one of several yet no
    process group spans them: every process would train the whole global
    batch and write the same artifacts as the primary.
    ``REHRSEG_NUM_PROCESSES=1`` is the explicit opt-out."""
    if os.environ.get("REHRSEG_NUM_PROCESSES") == "1":
        return
    n = _env_processes()
    formed = dist.is_available() and dist.is_initialized()
    if n > 1 and (not formed or dist.get_world_size() == 1):
        raise RuntimeError(
            f"the environment names {n} processes but no process group "
            "spans them — torch.distributed was not initialized. Call "
            "init_distributed() first (the CLI does), or set "
            "REHRSEG_COORDINATOR/REHRSEG_NUM_PROCESSES/REHRSEG_PROCESS_ID; "
            "refusing to run with every process acting as primary.")

