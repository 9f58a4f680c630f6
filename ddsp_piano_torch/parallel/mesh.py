"""Data parallelism over the cards of one host or of several, with
torch.distributed.

Counterpart of ddsp_piano_tpu/parallel/mesh.py. The JAX package runs one
process a host, which drives all of the host's devices, and GSPMD inserts
the gradient all-reduce into the jitted step. Here each card is driven by
a process of its own, a rank:

- a host is one CLI process (:func:`run`). With one rank it runs as it
  always did: no process group and no child process. With more, it starts
  one rank a card it uses (:func:`launch`, torch.multiprocessing.spawn);
  with one card a host in a multi-host run, it is the rank itself;
- the ranks of all hosts form one process group: global rank =
  process_id * local ranks + local rank, world = num_processes * local
  ranks. The backend follows the device, NCCL on ``cuda`` and gloo on
  ``cpu``; a caller may name another one, and nothing falls back;
- ``--batch_size`` is the global batch and each rank takes its rows of it
  (:func:`local_batch_slice`, :func:`slice_local_batch`). The Trainer
  all-reduces the gradients and the losses, so that a step over R ranks
  is one process's step on the global batch (training/trainer.py);
- the noise synth's draw is the one a single process makes for the global
  batch, of which each rank keeps its rows (:class:`RankDraw`). The draw
  folds voices voice-major, (n_synths, batch) -> n_synths * batch rows
  (models/dag.py), so a rank's rows are not one block (:func:`take_rows`).

The ranks of one host meet through a file in a temporary directory; hosts
meet at ``--coordinator_address`` (``host:port`` of process 0, or a
``file://`` path that every host sees), else at torch's ``MASTER_ADDR``
and ``MASTER_PORT``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = {'cuda': 'nccl', 'cpu': 'gloo'}
# How long a collective waits for a rank that does not come.
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Hosts:
    """The hosts of a run: process 0's rendezvous URL (None on one
    host), their number and this host's index."""
    address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0


_HOSTS = Hosts()
# (local rank, local ranks) of a rank made by init_rank.
_LOCAL: Optional[tuple] = None


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> bool:
    """Record the hosts of a multi-host run; call once per host before
    any rank starts. The coordinator is ``host:port`` of process 0 (or a
    URL), else ``$MASTER_ADDR:$MASTER_PORT``. Returns False, one host,
    without a coordinator."""
    global _HOSTS
    if (coordinator_address is None and os.environ.get('MASTER_ADDR')
            and os.environ.get('MASTER_PORT')):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if coordinator_address is None:
        _HOSTS = Hosts()
        return False
    if num_processes is None or process_id is None:
        raise ValueError("A multi-host run needs --num_processes and "
                         "--process_id beside its coordinator address.")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in [0, "
                         f"{num_processes})")
    address = (coordinator_address if '://' in coordinator_address
               else f'tcp://{coordinator_address}')
    _HOSTS = Hosts(address, int(num_processes), int(process_id))
    return True


def process_count() -> int:
    return _HOSTS.num_processes


def process_index() -> int:
    return _HOSTS.process_id


def in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def local_rank() -> int:
    return _LOCAL[0] if _LOCAL else rank()


def local_ranks() -> int:
    return _LOCAL[1] if _LOCAL else world_size()


def local_device(device) -> torch.device:
    """The card a rank runs on for a ``cuda`` device (the current one,
    which init_rank sets); the device itself outside a group."""
    device = torch.device(device)
    if device.type == 'cuda' and in_group():
        return torch.device('cuda', torch.cuda.current_device())
    return device


def get_world_for_batch(batch_size: int, n_devices: Optional[int] = None,
                        n_local: Optional[int] = None,
                        num_processes: Optional[int] = None) -> int:
    """The number of ranks: on one host, the largest count up to
    min(n_devices, n_local) that divides the batch (each rank takes as
    many rows); over several hosts, every card of every host, and the
    global batch must divide over them. ``n_local`` is the host's cards
    (default: the visible ones; on the CPU, its gloo ranks)."""
    if n_local is None:
        n_local = torch.cuda.device_count()
    if num_processes is None:
        num_processes = process_count()
    if num_processes > 1:
        n = num_processes * n_local
        if n_devices is not None and n_devices != n:
            warnings.warn(
                f"--n_devices={n_devices} is ignored in multi-process runs: "
                f"all {n} global devices must participate in the mesh.",
                stacklevel=2)
        if batch_size % n != 0:
            raise ValueError(f"Global batch {batch_size} must divide over "
                             f"the {n}-device multi-process mesh.")
        return n
    limit = n_local if n_devices is None else min(n_devices, n_local)
    return max(d for d in range(1, max(limit, 1) + 1) if batch_size % d == 0)


def local_batch_slice(batch_size: int, within_host: bool = False) -> slice:
    """This rank's rows of a batch of ``batch_size``: the global batch, or
    with ``within_host`` its host's share of it."""
    ranks, index = ((local_ranks(), local_rank()) if within_host
                    else (world_size(), rank()))
    if batch_size % ranks != 0:
        raise ValueError(f"Batch {batch_size} must divide over {ranks} "
                         "ranks.")
    per_rank = batch_size // ranks
    return slice(index * per_rank, (index + 1) * per_rank)


def slice_local_batch(batch: Dict[str, Any],
                      within_host: bool = False) -> Dict[str, Any]:
    """This rank's rows of each value of a batch dict that every rank of
    the group (or, with ``within_host``, of the host) holds in full.
    No-op with one rank."""
    if world_size() == 1:
        return batch
    first = next(iter(batch.values()))
    sl = local_batch_slice(first.shape[0], within_host)
    return {k: v[sl] for k, v in batch.items()}


def take_rows(x: torch.Tensor, global_batch: int) -> torch.Tensor:
    """This rank's rows of a draw for the global batch folded as (k,
    global_batch, ...) -> k * global_batch rows: (k * rows a rank, ...)."""
    if world_size() == 1:
        return x
    k = x.shape[0] // global_batch
    if k * global_batch != x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows do not fold over a global "
                         f"batch of {global_batch}")
    sl = local_batch_slice(global_batch)
    rest = tuple(x.shape[1:])
    return x.reshape((k, global_batch) + rest)[:, sl].reshape(
        (k * (sl.stop - sl.start),) + rest)


class RankDraw:
    """A noise synth's generator in a rank: the synth draws what a single
    process draws for the global batch from ``generator`` and keeps this
    rank's rows (processors/noise.py uniform_noise). Scalar draws (a loop
    shift for the whole batch) come from ``generator`` itself, the same in
    every rank."""

    def __init__(self, generator: torch.Generator, global_batch: int):
        self.generator = generator
        self.global_batch = int(global_batch)


# -- ranks -------------------------------------------------------------------


def init_rank(local_rank: int, local_ranks: int, hosts: Hosts,
              device_type: str, init_method: str,
              backend: Optional[str] = None,
              card: Optional[int] = None) -> None:
    """Join the process group as rank process_id * local_ranks +
    local_rank, on card ``card`` (default: the local rank) for ``cuda``,
    set before anything touches a card."""
    global _HOSTS, _LOCAL
    _HOSTS = hosts
    if device_type == 'cuda':
        torch.cuda.set_device(local_rank if card is None else card)
    dist.init_process_group(
        backend or BACKENDS[device_type], init_method=init_method,
        rank=hosts.process_id * local_ranks + local_rank,
        world_size=hosts.num_processes * local_ranks, timeout=TIMEOUT)
    _LOCAL = (local_rank, local_ranks)


def end_rank() -> None:
    global _LOCAL
    if in_group():
        dist.destroy_process_group()
    _LOCAL = None


def _rank_entry(local_rank: int, fn: Callable, args: Sequence,
                local_ranks: int, hosts: Hosts, device_type: str,
                backend: Optional[str], init_method: str,
                cards: Sequence[int], out_dir: str) -> None:
    init_rank(local_rank, local_ranks, hosts, device_type, init_method,
              backend, cards[local_rank])
    # A rank that raises leaves the group as it is: the launcher ends the
    # others (a rank may be waiting in a collective).
    result = fn(*args)
    torch.save(result, os.path.join(out_dir, f'rank{local_rank}.pt'))
    end_rank()


def launch(fn: Callable, n_ranks: int, args: Sequence = (),
           device_type: str = 'cuda', backend: Optional[str] = None,
           hosts: Optional[Hosts] = None,
           cards: Optional[Sequence[int]] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``n_ranks`` new processes, the host's ranks,
    each in the process group, and return what each returned (torch.save
    must take it: host tensors). A rank that raises ends the others and
    raises here. ``cards`` maps local ranks to cards (default: rank i on
    card i)."""
    hosts = _HOSTS if hosts is None else hosts
    cards = list(range(n_ranks)) if cards is None else list(cards)
    with tempfile.TemporaryDirectory(prefix='ddsp_ranks_') as out_dir:
        init_method = hosts.address or (
            'file://' + os.path.join(out_dir, 'rendezvous'))
        torch.multiprocessing.spawn(
            _rank_entry, nprocs=n_ranks, join=True,
            args=(fn, tuple(args), n_ranks, hosts, device_type, backend,
                  init_method, cards, out_dir))
        return [torch.load(os.path.join(out_dir, f'rank{i}.pt'),
                           weights_only=False) for i in range(n_ranks)]


def _call_portable(fn: Callable, args: Sequence,
                   portable: Optional[Callable]):
    result = fn(*args)
    return result if portable is None else portable(result)


def run(fn: Callable, args: Sequence, batch_size: int,
        n_devices: Optional[int], device,
        coordinator_address: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
        portable: Optional[Callable] = None):
    """A CLI's main over the ranks a batch takes: ``fn(*args)`` in this
    process (already a rank of a group; one rank in all; one card a host
    of a multi-host run), returning its result; else in the host's
    spawned ranks, returning each one's ``portable(result)`` in a list.
    On the CPU, ``n_devices`` is the host's count of gloo ranks."""
    if in_group():
        return fn(*args)
    initialize_multihost(coordinator_address, num_processes, process_id)
    device = torch.device(device)
    if device.type == 'cuda':
        n_local = torch.cuda.device_count()
    else:
        n_local = 1 if process_count() > 1 else (n_devices or 1)
    world = get_world_for_batch(batch_size, n_devices, n_local)
    local = world // process_count()
    if world == 1:
        return fn(*args)
    if local > 1:
        return launch(_call_portable, local, (fn, args, portable),
                      device.type)
    init_rank(0, 1, _HOSTS, device.type, _HOSTS.address)
    result = fn(*args)
    end_rank()
    return result
