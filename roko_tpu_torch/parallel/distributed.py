"""The processes of one run: their process group, rank and card.

Counterpart of ``roko_tpu/parallel/distributed.py``. A run of several
processes starts one process per card and gives each the same
``ROKO_COORDINATOR`` (``host:port`` of rank 0), ``ROKO_NUM_PROCESSES``
and its own ``ROKO_PROCESS_ID``, or passes them to :func:`initialize`.
Nothing else tells a process of the others: ``torch.distributed`` gets
its address, world size and rank from here.

On a card the backend is NCCL, with gloo beside it for the CPU tensors
of the corpus check (``datapipe.manifest.crosscheck_fingerprint``); on
the CPU it is gloo. Rank ``r`` drives card ``r % torch.cuda.device_count()``.
NCCL refuses two ranks on one card, so :func:`initialize` refuses that
layout itself, naming gloo: several ranks can share one card through
gloo, whose collectives take CUDA tensors for ``all_reduce``,
``broadcast`` and ``barrier``, all that data-parallel training needs on
the device. The backend changes only when the caller asks for it.

A dp x tp x sp grid (``parallel/mesh.py``) reduces over subgroups of the
run: :func:`grid_groups` makes them, every rank every group in one order,
as ``torch.distributed.new_group`` requires.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

ENV_COORDINATOR = "ROKO_COORDINATOR"
ENV_NUM_PROCESSES = "ROKO_NUM_PROCESSES"
ENV_PROCESS_ID = "ROKO_PROCESS_ID"

#: how long a collective, or the rendezvous, waits for a lost rank before
#: the run fails
TIMEOUT_S = 600.0

#: the backend :func:`initialize` chose, as the caller named it
_backend: Optional[str] = None


def _topology(coordinator_address: Optional[str], num_processes: Optional[int],
              process_id: Optional[int]) -> Optional[Tuple[str, int, int]]:
    """(coordinator, processes, rank) from the arguments and the
    environment, or None for a run of one process."""
    explicit = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])
    if explicit is None and num_processes is None:
        return None
    missing = [name for name, v in ((ENV_COORDINATOR, explicit),
                                    (ENV_NUM_PROCESSES, num_processes),
                                    (ENV_PROCESS_ID, process_id)) if v is None]
    if missing:
        raise ValueError(f"a run of several processes needs {', '.join(missing)} as well "
                         "(or the matching arguments of initialize)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")
    return explicit, num_processes, process_id


def refuse_shared_cards(cards: List[str]) -> None:
    """Raise unless every rank's ``host:card`` differs: NCCL refuses two
    ranks on one card."""
    seen = {}
    for r, card in enumerate(cards):
        if card in seen:
            raise ValueError(
                f"ranks {seen[card]} and {r} share card {card}, and NCCL refuses two ranks "
                "on one card: start one rank per card, or ask for backend='gloo', whose "
                "collectives take CUDA tensors (all_reduce, broadcast, barrier)")
        seen[card] = r


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> bool:
    """Join the run's process group when the arguments or the ``ROKO_*``
    environment name several processes; True when the group has more
    than one rank. One process (nothing named) returns False without
    touching ``torch.distributed``. ``backend`` defaults to NCCL for a
    CUDA ``device`` and gloo for the CPU. Idempotent: a second call keeps
    the group the first one made. A rank that does not arrive within
    :data:`TIMEOUT_S` fails the run."""
    global _backend
    topo = _topology(coordinator_address, num_processes, process_id)
    if topo is None:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    address, n, rank = topo
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; expected nccl or gloo")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() is false; ask "
                "for the CPU explicitly (device='cpu', --device cpu)")
        torch.cuda.set_device(card_of_rank(rank))
    elif backend == "nccl":
        raise ValueError("backend 'nccl' needs a CUDA device; the CPU runs on gloo")
    host, port = address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store = dist.TCPStore(host, int(port), n, is_master=rank == 0, timeout=timeout)
    if backend == "nccl":
        store.set(f"roko/card/{rank}", f"{socket.gethostname()}:{card_of_rank(rank)}")
        refuse_shared_cards([store.get(f"roko/card/{r}").decode() for r in range(n)])
    # NCCL takes the CUDA tensors and gloo the CPU ones (the corpus check)
    spec = "cpu:gloo,cuda:nccl" if backend == "nccl" else "gloo"
    dist.init_process_group(spec, store=store, world_size=n, rank=rank, timeout=timeout)
    _backend = backend
    return n > 1


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank; 0 in a run of one process."""
    import torch.distributed as dist

    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The processes of the run; 1 without a process group."""
    import torch.distributed as dist

    return dist.get_world_size() if is_initialized() else 1


def backend() -> Optional[str]:
    """"nccl" or "gloo" as :func:`initialize` chose it; None without a group."""
    return _backend if is_initialized() else None


def is_primary() -> bool:
    """True on the rank that logs and writes checkpoints and the FASTA."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank; nothing in a run of one process."""
    import torch.distributed as dist

    if is_initialized():
        dist.barrier()


def card_of_rank(r: int) -> int:
    """The card index rank ``r`` drives: ``r % torch.cuda.device_count()``."""
    return r % torch.cuda.device_count()


def device_of_rank(device: Union[str, torch.device]) -> torch.device:
    """``device`` for this rank: a CUDA device without an index becomes
    this rank's card in a process group; anything else stays as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and is_initialized():
        return torch.device("cuda", card_of_rank(rank()))
    return dev


def grid_members(dp: int, tp: int, sp: int) -> Dict[str, List[List[int]]]:
    """The ranks of every subgroup of a dp x tp x sp grid laid out
    row-major (rank ``(d * tp + t) * sp + s``), by axis: ``dp`` (the ranks
    that share t and s), ``tp`` (share d and s), ``sp`` (share d and t)
    and ``dp_sp`` (share t)."""

    def at(d: int, t: int, s: int) -> int:
        return (d * tp + t) * sp + s

    D, T, S = range(dp), range(tp), range(sp)
    return {
        "dp": [[at(d, t, s) for d in D] for t in T for s in S],
        "tp": [[at(d, t, s) for t in T] for d in D for s in S],
        "sp": [[at(d, t, s) for s in S] for d in D for t in T],
        "dp_sp": [[at(d, t, s) for d in D for s in S] for t in T],
    }


def grid_groups(dp: int, tp: int, sp: int) -> Dict[str, Any]:
    """This rank's process group on each axis of :func:`grid_members`.
    Every rank creates every group, in the same order, or a rank that
    skips one hangs the run. A group of the whole run is the default
    group, a group of one rank is None (its collectives are no-ops);
    without a process group every one is None."""
    import torch.distributed as dist

    out: Dict[str, Any] = dict.fromkeys(("dp", "tp", "sp", "dp_sp"))
    if not is_initialized():
        return out
    me, n = rank(), world_size()
    for axis, groups in grid_members(dp, tp, sp).items():
        for ranks in groups:
            if len(ranks) == n:
                group = dist.group.WORLD
            elif len(ranks) == 1:
                group = None
            else:
                group = dist.new_group(ranks)
            if me in ranks:
                out[axis] = group
    return out


def all_gather_cpu(t: torch.Tensor, group: Any = "world") -> torch.Tensor:
    """``[ranks, *t.shape]``: the ``t`` of every rank of ``group`` (default
    the whole run; None, a group of one rank), a CPU tensor, in rank order
    (gloo, the one backend that gathers CPU tensors)."""
    import torch.distributed as dist

    t = t.cpu().contiguous()
    if group == "world":
        group = dist.group.WORLD if is_initialized() else None
    if group is None:
        return t.unsqueeze(0)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.stack(out)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    global _backend
    import torch.distributed as dist

    if is_initialized():
        dist.destroy_process_group()
    _backend = None
