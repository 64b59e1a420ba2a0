"""The serving mesh: its axes, the process groups of a ``tp x ep`` world
and the collectives the sharded forward calls
(``production_stack_tpu/parallel/mesh.py``).

The JAX package lays the slice's chips out as a ``jax.sharding.Mesh``
and lets XLA insert the collectives its sharding annotations imply. Here
every rank is a process (the engine is rank 0, parallel/workers.py
starts the others) and the forward calls the collectives itself, over
torch.distributed process groups built from one store:

- a **tp group** within each ep slice (ranks ``ep_rank * tp .. + tp``):
  the all-reduce after the row-parallel ``o`` and ``down`` products and
  after the vocab-parallel embedding, and the gather of the vocab slices
  of the logits;
- the **world** group (every rank): the all-reduce that combines the
  routed experts' partial outputs, each rank holding E / ep experts with
  their inner dimension over tp;
- a **control** group on the CPU (gloo, every rank): the start-up
  barrier and small reports, off the device.

Ranks are numbered ``ep_rank * tp + tp_rank``: tp innermost, as the JAX
mesh reshapes its devices ``(pp, dp, sp, ep, tp)``.

The backend is chosen once, by this rule, and logged at engine start:
NCCL where every rank has a card of its own, gloo where ranks share a
card (rank r runs on ``cuda:(r % device_count)``) and gloo on the CPU.
Nothing falls back from one to the other. gloo carries CUDA tensors for
all_reduce and broadcast (staged through the host), so the gather over
gloo is an all_reduce of a zero-filled buffer into which each rank has
written its slice: exact, as every element is one rank's value plus
zeros. Every group is built with the timeout it is given: a collective
whose peer died raises, it never hangs.
"""

import collections
import dataclasses
import datetime
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("pp", "dp", "sp", "ep", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.sp * self.tp * self.ep * self.pp

    @staticmethod
    def for_devices(n: int, tp: Optional[int] = None,
                    sp: Optional[int] = None) -> "MeshConfig":
        """Factor n devices into (dp, sp, tp). Defaults favor a balanced
        mesh that activates every axis when divisibility allows (8 chips
        -> 2x2x2), with tp on the innermost axis."""
        if tp is None:
            tp = 2 if n % 2 == 0 else 1
        if n % tp:
            raise ValueError(f"tp={tp} does not divide {n} devices")
        rest = n // tp
        if sp is None:
            sp = 2 if rest % 2 == 0 and rest >= 2 else 1
        if rest % sp:
            raise ValueError(f"sp={sp} does not divide {rest} devices")
        cfg = MeshConfig(dp=rest // sp, sp=sp, tp=tp)
        assert cfg.size == n
        return cfg


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's coordinates on a serving mesh (dp = sp = pp = 1): its
    index along tp and ep and the axes' sizes."""
    tp: int = 1
    ep: int = 1
    tp_rank: int = 0
    ep_rank: int = 0

    @staticmethod
    def of(cfg: MeshConfig, rank: int) -> "Shard":
        if cfg.size != cfg.tp * cfg.ep:
            raise ValueError(f"a serving mesh has tp and ep axes only "
                             f"(got {cfg})")
        if not 0 <= rank < cfg.size:
            raise ValueError(f"rank {rank} outside a world of {cfg.size}")
        return Shard(tp=cfg.tp, ep=cfg.ep, tp_rank=rank % cfg.tp,
                     ep_rank=rank // cfg.tp)

    @property
    def rank(self) -> int:
        return self.ep_rank * self.tp + self.tp_rank

    @property
    def world(self) -> int:
        return self.tp * self.ep

    def axis(self, name: Optional[str]) -> Tuple[int, int]:
        """(index, size) of this rank along a mesh axis; (0, 1) along
        the axes a serving mesh does not split (and None)."""
        if name == "tp":
            return self.tp_rank, self.tp
        if name == "ep":
            return self.ep_rank, self.ep
        return 0, 1


def rank_device(device: torch.device, rank: int) -> torch.device:
    """The device of rank r: the CPU, or ``cuda:(r % device_count)``."""
    if device.type == "cpu":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def choose_backend(device: torch.device, world: int) -> str:
    """nccl where every rank has a card of its own, gloo where ranks
    share a card and on the CPU."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def device_map(device: torch.device, world: int) -> Dict[int, str]:
    """rank -> device, as rank_device places them."""
    return {r: str(rank_device(device, r)) for r in range(world)}


def _group(backend: str, store, prefix: str, rank: int, size: int,
           timeout: datetime.timedelta):
    sub = dist.PrefixStore(prefix, store)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(sub, rank, size, opts)
    return dist.ProcessGroupGloo(sub, rank, size, timeout)


class ServingMesh:
    """One rank's view of a ``tp x ep`` serving world: its coordinates
    (``shard``), its device, the backend, the tp / world / control
    groups, and the collectives of the sharded forward. ``calls`` counts
    the collectives issued, by axis and kind."""

    def __init__(self, cfg: MeshConfig, rank: int, store,
                 device: torch.device, timeout_s: float):
        self.cfg = cfg
        self.shard = Shard.of(cfg, rank)
        self.device = rank_device(device, rank)
        self.backend = choose_backend(device, cfg.size)
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)
        timeout = datetime.timedelta(seconds=timeout_s)
        s = self.shard
        self.groups = {}
        if s.tp > 1:
            self.groups["tp"] = _group(self.backend, store,
                                       f"tp{s.ep_rank}", s.tp_rank, s.tp,
                                       timeout)
        if s.world > 1 and s.ep > 1:
            self.groups["world"] = _group(self.backend, store, "world",
                                          s.rank, s.world, timeout)
        elif "tp" in self.groups:
            # one ep slice: the world is the tp group
            self.groups["world"] = self.groups["tp"]
        self.control = dist.ProcessGroupGloo(
            dist.PrefixStore("control", store), s.rank, s.world, timeout)
        self.calls: Dict[str, int] = collections.Counter()

    def size(self, axis: str) -> int:
        return self.shard.world if axis == "world" else \
            self.shard.axis(axis)[1]

    def all_reduce(self, t: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        """Sum t over the ranks of `axis` ("tp": this rank's ep slice,
        "world": every rank), in place; a size-1 axis is a no-op."""
        group = self.groups.get(axis)
        if group is None:
            return t
        t = t.contiguous()
        group.allreduce([t]).wait()
        self.calls[axis + ".all_reduce"] += 1
        return t

    def all_gather(self, t: torch.Tensor, dim: int,
                   axis: str = "tp") -> torch.Tensor:
        """The ranks' tensors of `axis` concatenated along `dim`, in rank
        order, on every rank of the axis."""
        group = self.groups.get(axis)
        if group is None:
            return t
        n = self.size(axis)
        index = self.shard.tp_rank if axis == "tp" else self.shard.rank
        if self.backend == "nccl":
            buf = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                              device=t.device)
            group._allgather_base(buf, t.contiguous()).wait()
        else:
            buf = torch.zeros((n,) + tuple(t.shape), dtype=t.dtype,
                              device=t.device)
            buf[index] = t
            group.allreduce([buf]).wait()
        self.calls[axis + ".all_gather"] += 1
        dim = dim % t.dim()
        return torch.cat(buf.unbind(0), dim=dim)

    def barrier(self) -> None:
        """Every rank reaches this point (the CPU control group)."""
        flag = torch.ones(1)
        self.control.allreduce([flag]).wait()
        if int(flag.item()) != self.shard.world:
            raise RuntimeError(f"barrier counted {flag.item()} ranks of "
                               f"{self.shard.world}")

    def describe(self) -> dict:
        return {"backend": self.backend, "tp": self.shard.tp,
                "ep": self.shard.ep,
                "ranks": device_map(self.device if self.device.type == "cpu"
                                    else torch.device("cuda"),
                                    self.shard.world)}

