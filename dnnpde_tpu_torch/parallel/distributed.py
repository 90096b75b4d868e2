"""Process groups of the port's parallel paths, the counterpart of
``dnnpde_tpu/parallel/distributed.py``.

Every rank of a run calls :func:`init_distributed` first; after it,
``make_mesh`` spans the group's ranks and ``Trainer(mesh=...)``, the
explicit-collective step and the sharded ensembles work as in JAX, with the
loss, gradient and gather reductions as ``torch.distributed`` collectives.

- The ranks run on the cards unless the caller passes ``device="cpu"``.
- The backend is NCCL when every rank of a host has a card of its own (the
  host's ranks no more than ``torch.cuda.device_count()``), and gloo
  otherwise: on the CPU, or several ranks sharing one card. The choice is
  made from those counts, never by trying one and catching its failure.
- Rank r drives ``cuda:{local_rank % device_count}``, set as the current
  device, so that ``device=None`` resolves to it.
- The group has a finite timeout, so a collective posted out of order fails
  instead of hanging.

:func:`launch` starts n ranks of one command on this host, rendezvousing
over a file store (``store=``) or a free loopback port: the CLI's ``--dp``
and the tests use it. Every collective of the port goes through
:func:`all_reduce`, whose ``calls`` attribute counts what was posted.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import tempfile
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from dnnpde_tpu_torch.runtime import default_device

STORE_ENV = "DNNPDE_DIST_STORE"  # the file store the local launcher names
TIMEOUT_S = 300.0  # a collective that waits longer fails


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """Join this process to the run's group.

    With no arguments the rank and world size come from torchrun's variables
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``: ``env://``),
    or from :func:`launch`, whose ranks rendezvous over the file store it
    names. ``coordinator_address`` (``"host:port"``, ``"tcp://host:port"``
    or ``"file:///path"``) with ``num_processes`` and ``process_id`` sets
    them by hand. ``device``: None for the cards (raises without CUDA),
    "cpu" for ranks on the CPU. Call it once per process.

    The backend and the card depend on this host's share of the ranks,
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (torchrun and :func:`launch`
    set them). Without them every rank must be on this host (a file store,
    or a loopback address), and then the host has them all; otherwise this
    raises ValueError rather than guess."""
    kind = default_device(device).type
    if dist.is_initialized():
        raise RuntimeError("init_distributed was already called in this process")
    if coordinator_address is None:
        store = os.environ.get(STORE_ENV)
        init_method = f"file://{store}" if store else "env://"
        world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    local_rank, local_world = _local_layout(init_method, rank, world)
    n_cards = torch.cuda.device_count() if kind == "cuda" else 0
    backend = _backend(local_world, n_cards)
    kwargs = {}
    if n_cards:
        card = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(card)
        if backend == "nccl":
            kwargs["device_id"] = card
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S), **kwargs)


def _one_host(init_method: str) -> bool:
    """Whether a rendezvous can only gather ranks of this host: a file
    store, or a loopback address (``env://`` reads ``MASTER_ADDR``)."""
    if init_method.startswith("file://"):
        return True
    if init_method == "env://":
        host = os.environ.get("MASTER_ADDR", "")
    else:
        host = init_method.split("://", 1)[1].rsplit(":", 1)[0].strip("[]")
    return host == "localhost" or host == "::1" or host.startswith("127.")


def _local_layout(init_method: str, rank: int, world: int) -> tuple[int, int]:
    """(this rank's index on its host, the host's rank count)."""
    local_rank, local_world = os.environ.get("LOCAL_RANK"), os.environ.get("LOCAL_WORLD_SIZE")
    if local_rank is not None and local_world is not None:
        return int(local_rank), int(local_world)
    if not _one_host(init_method):
        raise ValueError(
            f"init_distributed over {init_method} may span hosts, so this host's share of the "
            f"{world} ranks is unknown: set LOCAL_RANK and LOCAL_WORLD_SIZE")
    return rank, world


def _backend(local_world: int, n_cards: int) -> str:
    """NCCL when each of a host's ``local_world`` ranks has a card of its
    own among the host's ``n_cards`` (0 on the CPU), gloo otherwise."""
    return "nccl" if 0 < local_world <= n_cards else "gloo"


def is_multi_host() -> bool:
    """More than one rank in the group (JAX: more than one process)."""
    return dist.is_initialized() and dist.get_world_size() > 1


def global_device_summary() -> dict:
    """The group's layout for logs, with JAX's keys. Each rank drives one
    device, the one member of the mesh it contributes."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` in place over ``group`` (None: the world) and return
    it; counted in ``all_reduce.calls``."""
    all_reduce.calls += 1
    dist.all_reduce(tensor, group=group)
    return tensor


all_reduce.calls = 0


def gather_rows(local: torch.Tensor, n_total: int, group=None, dim: int = 0) -> torch.Tensor:
    """The concatenation along ``dim`` of every rank's equal ``local`` block,
    in rank order, on every rank: one :func:`all_reduce` of a zero-filled
    buffer into which each rank writes its own block (x + 0 is exact, and
    gloo has no all-gather of CUDA tensors)."""
    rank = dist.get_rank(group)
    shape = list(local.shape)
    n = shape[dim]
    shape[dim] = n_total
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    full.narrow(dim, rank * n, n).copy_(local)
    return all_reduce(full, group)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(
    nprocs: int,
    argv: Sequence[str],
    *,
    store: Optional[str] = None,
    timeout_s: Optional[float] = 600.0,
    capture: bool = True,
) -> list[tuple[int, str, str]]:
    """Run ``argv`` as ``nprocs`` ranks on this host and wait for them.

    Each rank gets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE`` and one intra-op thread (``OMP_NUM_THREADS=1``)
    beside this process's environment, and rendezvouses over
    the file ``store`` (a path that does not exist yet) or, without one,
    over a free loopback port. When a rank fails, the others are stopped;
    past ``timeout_s`` (None: no limit) all are. Returns each rank's (exit
    code, stdout, stderr) (empty strings with ``capture=False``, where the
    ranks write to this process's streams); raises RuntimeError when a rank
    failed or the wall limit passed."""
    base = dict(os.environ)
    base.update(WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs), OMP_NUM_THREADS="1")
    if store is not None:
        base[STORE_ENV] = str(store)
    else:
        base.pop(STORE_ENV, None)
        base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    with tempfile.TemporaryDirectory() as logs:
        procs, files = [], []
        for r in range(nprocs):
            rank_env = dict(base, RANK=str(r), LOCAL_RANK=str(r))
            if capture:
                out = open(os.path.join(logs, f"{r}.out"), "w+")
                err = open(os.path.join(logs, f"{r}.err"), "w+")
                files.append((out, err))
            else:
                out = err = None
            procs.append(subprocess.Popen(list(argv), env=rank_env, stdout=out, stderr=err))
        deadline = time.monotonic() + (float("inf") if timeout_s is None else timeout_s)
        failed = timed_out = False
        try:
            while any(p.poll() is None for p in procs):
                failed = any(p.returncode not in (None, 0) for p in procs)
                timed_out = time.monotonic() > deadline
                if failed or timed_out:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for r, p in enumerate(procs):
            texts = ["", ""]
            if capture:
                for i, f in enumerate(files[r]):
                    f.seek(0)
                    texts[i] = f.read()
                    f.close()
            results.append((p.returncode, texts[0], texts[1]))
    bad = [(r, rc, err) for r, (rc, _, err) in enumerate(results) if rc != 0]
    if timed_out or bad:
        why = f"passed its wall limit of {timeout_s:.0f} s" if timed_out else "failed"
        detail = "\n".join(f"rank {r}: exit code {rc}\n{err[-3000:]}" for r, rc, err in bad)
        raise RuntimeError(f"a launch of {nprocs} ranks {why}:\n{detail}")
    return results
