"""The learner's data-parallel group.

Counterpart of `ray_tpu/parallel/mesh.py`. The JAX learner ran one
program over a `dp` mesh of devices; the port runs one process per
device in a `torch.distributed` world (`parallel/distributed.py`), and
`LearnerGroup` is what the learner needs of that world: its rank, its
size, this rank's `torch.device`, the backend, and the transport of the
collectives the update issues.

The transport: NCCL moves device buffers directly, one rank per card.
gloo moves CPU tensors directly; for a buffer on a card (several ranks
sharing one card) it stages the buffer through pinned host memory
that it allocates once per shape, and adds the copies' host time to
`staging_s`. The encode and decode of the q8 exchange run on the card
either way (`parallel/collectives.py`).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from .distributed import BACKENDS


def pad_to_multiple(batch_size: int, n: int) -> int:
    """Smallest multiple of n >= batch_size."""
    return ((batch_size + n - 1) // n) * n


def _all_gather_single(out: torch.Tensor, inp: torch.Tensor) -> None:
    """`out` [world_size, *inp.shape] <- every rank's `inp`, in rank
    order: all_gather_single where this torch has it (it deprecates
    all_gather_into_tensor), else the older name; on the concatenated
    form, which every backend takes."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out.view(-1), inp.reshape(-1))


class LearnerGroup:
    """This rank's view of the learner world."""

    def __init__(self, device: torch.device):
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.backend = dist.get_backend()
        self.device = device
        # gloo with a buffer on a card: stage through pinned host memory.
        self.staged = self.backend == "gloo" and device.type == "cuda"
        self.staging_s = 0.0
        self._pinned: Dict[Tuple, torch.Tensor] = {}

    @classmethod
    def from_world(cls, world_size: int, backend: str,
                   device_spec=None) -> "LearnerGroup":
        """The group of an initialized world of exactly `world_size`
        ranks running `backend`. Under NCCL rank r uses `cuda:r` and
        the host must have a card per rank; under gloo every rank uses
        the configured device. Anything else raises: nothing switches
        backend or device by itself."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown collective_backend {backend!r}; "
                             f"known: {BACKENDS}")
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"num_gpus_for_learner={world_size} needs a "
                f"torch.distributed world of {world_size} ranks: start "
                "one with ray_tpu_torch.parallel.distributed.launch (or "
                "initialize) and build the trainer on every rank")
        if dist.get_world_size() != world_size:
            raise ValueError(
                f"num_gpus_for_learner={world_size} but the "
                f"torch.distributed world has {dist.get_world_size()} "
                "rank(s)")
        if dist.get_backend() != backend:
            raise ValueError(
                f"collective_backend={backend!r} but the world was "
                f"initialized with {dist.get_backend()!r}")
        device = resolve_device(device_spec)
        if backend == "nccl":
            if device.type != "cuda":
                raise ValueError("collective_backend='nccl' runs on cards; "
                                 f"the configured device is {device}")
            cards = torch.cuda.device_count()
            if cards < world_size:
                raise ValueError(
                    f"collective_backend='nccl' puts one rank on each "
                    f"card: {world_size} ranks but {cards} card(s); use "
                    "'gloo' for ranks that share a card")
            device = torch.device("cuda", dist.get_rank())
            # NCCL's object collectives use the current device.
            torch.cuda.set_device(device)
        return cls(device)

    # -- staging ---------------------------------------------------------
    def _host(self, role: str, shape, dtype) -> torch.Tensor:
        key = (role, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _to_host(self, buf: torch.Tensor, role: str) -> torch.Tensor:
        # Wait for the work that produces `buf` first, so the copy's
        # time is the copy's own.
        torch.cuda.current_stream(buf.device).synchronize()
        t0 = time.perf_counter()
        host = self._host(role, buf.shape, buf.dtype)
        host.copy_(buf)
        self.staging_s += time.perf_counter() - t0
        return host

    def _to_device(self, host: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        t0 = time.perf_counter()
        if out is None:
            out = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
        out.copy_(host)  # blocking: the pinned buffer is reused
        self.staging_s += time.perf_counter() - t0
        return out

    # -- collectives -----------------------------------------------------
    def all_gather(self, buf: torch.Tensor) -> torch.Tensor:
        """[*shape] from every rank -> [world_size, *shape], rank order."""
        shape = (self.world_size,) + tuple(buf.shape)
        if not self.staged:
            out = torch.empty(shape, dtype=buf.dtype, device=buf.device)
            _all_gather_single(out, buf.contiguous())
            return out
        host_out = self._host("gather_out", shape, buf.dtype)
        _all_gather_single(host_out, self._to_host(buf, "gather_in"))
        return self._to_device(host_out)

    def all_reduce_(self, buf: torch.Tensor) -> torch.Tensor:
        """Sum over ranks, in place; every rank gets the same result."""
        if not self.staged:
            dist.all_reduce(buf)
            return buf
        host = self._to_host(buf, "reduce")
        dist.all_reduce(host)
        return self._to_device(host, buf)

    def broadcast_(self, buf: torch.Tensor, src: int = 0) -> torch.Tensor:
        """`src`'s buffer on every rank, in place."""
        if not self.staged:
            dist.broadcast(buf, src)
            return buf
        host = self._to_host(buf, "broadcast")
        dist.broadcast(host, src)
        return self._to_device(host, buf)

    def all_gather_object(self, obj: Any) -> List[Any]:
        """A picklable object from every rank, in rank order."""
        out: List[Any] = [None] * self.world_size
        dist.all_gather_object(out, obj)
        return out

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """`src`'s object on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src)
        return box[0]
