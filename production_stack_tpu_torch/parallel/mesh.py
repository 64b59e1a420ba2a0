"""The meshes: their axes, the process groups of a ``dp x ep x tp``
serving world and of a ``(pp, dp, sp, tp)`` training world, and the
collectives the sharded forward and backward call
(``production_stack_tpu/parallel/mesh.py``).

The JAX package lays the slice's chips out as a ``jax.sharding.Mesh``
and lets XLA insert the collectives its sharding annotations imply. Here
every rank is a process (the engine is rank 0, parallel/workers.py
starts the others) and the forward calls the collectives itself, over
torch.distributed process groups built from one store:

- a **tp group** for each line of tp ranks (one per dp replica and ep
  slice): the all-reduce after the row-parallel ``o`` and ``down``
  products and after the vocab-parallel embedding, and the gather of
  the vocab slices of the logits;
- the **world** group of each dp replica (its ep x tp ranks; every rank
  when dp = 1): the all-reduce that combines the routed experts'
  partial outputs, each rank holding E / ep experts with their inner
  dimension over tp. It spans one replica only: a group over every
  rank would add each replica's partials to the others';
- a **dp group** for each (ep, tp) position (its dp ranks): the
  assembly of the KV pool's blocks, which dp splits (models/kv.py),
  summed bit for bit (``assemble``);
- a **control** group on the CPU (gloo, every rank): the start-up
  barrier and small reports, off the device.

Ranks are numbered ``(dp_rank * ep + ep_rank) * tp + tp_rank``: tp
innermost, as the JAX mesh reshapes its devices ``(pp, dp, sp, ep,
tp)``.

A training world (``TrainWorld``) numbers its ranks by the same reshape
with ep = 1 and builds, from one store, a group for each line of ranks
along an axis: tp (the megatron collectives), sp (ring attention's
hops), dp and dp x sp ("data": the gradients' sum), pp (the pipeline's
hops). XLA derives the backward's collectives from the shardings; here
the forward calls autograd Functions whose backward is the adjoint:
- ``all_reduce`` after a row-parallel product and after the
  vocab-parallel embedding: its result feeds computation every tp rank
  repeats, whose gradient each rank holds whole, so the backward is the
  identity;
- ``copy_to_tp`` ahead of the column-parallel products: the identity,
  whose backward sums the ranks' partial gradients over tp;
- ``all_gather`` of the logits' vocabulary blocks: the backward takes
  the rank's block;
- ``ppermute``: a shift along an axis, cyclic (the ring) or not (the
  pipeline, where the first rank receives zeros), whose backward is the
  reverse shift.
A shift is one ``alltoall_base`` over the axis's group with one peer
each way, so no pair of ranks waits on each other's send; gloo carries
it on host tensors, so a CUDA tensor is staged through the host there.

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
    """A rank's coordinates on a serving mesh (sp = pp = 1): its index
    along tp, ep and dp and the axes' sizes."""
    tp: int = 1
    ep: int = 1
    tp_rank: int = 0
    ep_rank: int = 0
    dp: int = 1
    dp_rank: int = 0

    @staticmethod
    def of(cfg: MeshConfig, rank: int) -> "Shard":
        if cfg.sp != 1 or cfg.pp != 1:
            raise ValueError(f"a serving mesh has dp, ep and tp axes only "
                             f"(got {cfg})")
        if not 0 <= rank < cfg.size:
            raise ValueError(f"rank {rank} outside a world of {cfg.size}")
        return Shard(tp=cfg.tp, ep=cfg.ep, tp_rank=rank % cfg.tp,
                     ep_rank=rank // cfg.tp % cfg.ep, dp=cfg.dp,
                     dp_rank=rank // (cfg.tp * cfg.ep))

    @property
    def rank(self) -> int:
        return (self.dp_rank * self.ep + self.ep_rank) * self.tp \
            + self.tp_rank

    @property
    def world(self) -> int:
        """Every rank of the serving world: dp x ep x tp."""
        return self.dp * self.ep * self.tp

    def axis(self, name: Optional[str]) -> Tuple[int, int]:
        """(index, size) of this rank along a mesh axis, or along
        "world", one dp replica's ep x tp ranks; (0, 1) along the axes a
        serving mesh does not split (and None)."""
        if name == "tp":
            return self.tp_rank, self.tp
        if name == "ep":
            return self.ep_rank, self.ep
        if name == "dp":
            return self.dp_rank, self.dp
        if name == "world":
            return self.ep_rank * self.tp + self.tp_rank, self.ep * self.tp
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


def _all_gather(group, backend: str, t: torch.Tensor, dim: int, n: int,
                index: int) -> torch.Tensor:
    """The group's tensors concatenated along dim, in rank order; over
    gloo an all_reduce of a zero-filled buffer holding this rank's t."""
    if backend == "nccl":
        buf = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        group._allgather_base(buf, t.contiguous()).wait()
    else:
        buf = torch.zeros((n,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        buf[index] = t
        group.allreduce([buf]).wait()
    return torch.cat(buf.unbind(0), dim=dim % t.dim())


class ServingMesh:
    """One rank's view of a ``dp x ep x tp`` serving world: its
    coordinates (``shard``), its device, the backend, the tp / world /
    dp / control groups, and the collectives of the sharded forward.
    ``calls`` counts the collectives issued, by axis and kind."""

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
                                       f"tp{s.dp_rank}.{s.ep_rank}",
                                       s.tp_rank, s.tp, timeout)
        if s.ep > 1:
            self.groups["world"] = _group(self.backend, store,
                                          f"world{s.dp_rank}",
                                          *s.axis("world"), timeout)
        elif "tp" in self.groups:
            # one ep slice: a replica's world is its tp group
            self.groups["world"] = self.groups["tp"]
        if s.dp > 1:
            self.groups["dp"] = _group(self.backend, store,
                                       f"dp{s.ep_rank}.{s.tp_rank}",
                                       s.dp_rank, s.dp, timeout)
        self.control = dist.ProcessGroupGloo(
            dist.PrefixStore("control", store), s.rank, s.world, timeout)
        self.calls: Dict[str, int] = collections.Counter()

    def size(self, axis: str) -> int:
        return self.shard.axis(axis)[1]

    def all_reduce(self, t: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        """Sum t over the ranks of `axis` ("tp": this rank's tp line,
        "world": its dp replica, "dp": its dp line), in place; a size-1
        axis is a no-op."""
        group = self.groups.get(axis)
        if group is None:
            return t
        t = t.contiguous()
        group.allreduce([t]).wait()
        self.calls[axis + ".all_reduce"] += 1
        return t

    def assemble(self, t: torch.Tensor, axis: str = "dp") -> torch.Tensor:
        """The whole of a tensor of which each rank of `axis` holds some
        elements and zeros elsewhere (every element held by one rank),
        on every rank of the axis, bit for bit: the ranks' bit patterns
        are summed as integers (int32 words for 2- and 4-byte floats,
        int8 as it is), where a float sum would turn an owner's -0.0
        into +0.0. A size-1 axis: t."""
        group = self.groups.get(axis)
        if group is None:
            return t
        t = t.contiguous()
        if t.element_size() == 1:
            bits = t
        elif t.element_size() == 4 or (t.element_size() == 2
                                       and t.shape[-1] % 2 == 0):
            bits = t.view(torch.int32)
        else:
            raise ValueError(f"assemble takes 1- and 4-byte elements and "
                             f"2-byte ones in pairs (got {t.dtype} "
                             f"{tuple(t.shape)})")
        group.allreduce([bits]).wait()
        self.calls[axis + ".assemble"] += 1
        return bits.view(t.dtype)

    def copy_to_tp(self, t: torch.Tensor) -> torch.Tensor:
        """The activation ahead of the column-parallel products: serving
        takes no gradient, so t as it is."""
        return t

    def all_gather(self, t: torch.Tensor, dim: int,
                   axis: str = "tp") -> torch.Tensor:
        """The ranks' tensors of `axis` concatenated along `dim`, in rank
        order, on every rank of the axis."""
        group = self.groups.get(axis)
        if group is None:
            return t
        index, size = self.shard.axis(axis)
        out = _all_gather(group, self.backend, t, dim, size, index)
        self.calls[axis + ".all_gather"] += 1
        return out

    def barrier(self) -> None:
        """Every rank reaches this point (the CPU control group)."""
        flag = torch.ones(1)
        self.control.allreduce([flag]).wait()
        if int(flag.item()) != self.shard.world:
            raise RuntimeError(f"barrier counted {flag.item()} ranks of "
                               f"{self.shard.world}")

    def describe(self) -> dict:
        return {"backend": self.backend, "dp": self.shard.dp,
                "tp": self.shard.tp, "ep": self.shard.ep,
                "ranks": device_map(self.device if self.device.type == "cpu"
                                    else torch.device("cuda"),
                                    self.shard.world)}


# ------------------------------------------------------------- training

# the training world's groups: each axis, and the data axis (dp x sp)
# over which the gradients of a sequence-parallel step are summed
TRAIN_GROUPS = {"pp": ("pp",), "dp": ("dp",), "sp": ("sp",), "tp": ("tp",),
                "data": ("dp", "sp")}


def train_coords(cfg: MeshConfig, rank: int) -> Dict[str, int]:
    """A training rank's index along each axis: the JAX mesh's reshape
    of its devices (pp, dp, sp, ep, tp), tp innermost, ep = 1."""
    if cfg.ep != 1:
        raise ValueError(f"a training world has no ep axis (got {cfg})")
    if not 0 <= rank < cfg.size:
        raise ValueError(f"rank {rank} outside a world of {cfg.size}")
    coords = {}
    for axis in reversed(AXES):
        n = getattr(cfg, axis)
        coords[axis] = rank % n
        rank //= n
    return {axis: coords[axis] for axis in AXES if axis != "ep"}


class _AllReduce(torch.autograd.Function):
    """Sum over a tp line; the backward is the identity (TrainWorld)."""

    @staticmethod
    def forward(ctx, t, world, axis):
        return world.reduce_(t.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToTP(torch.autograd.Function):
    """The identity; the backward sums the gradient over tp."""

    @staticmethod
    def forward(ctx, t, world):
        ctx.world = world
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.world.reduce_(g.contiguous().clone(), "tp"), None


class _AllGather(torch.autograd.Function):
    """Concatenate the tp ranks' blocks; the backward is this rank's
    block of the gradient."""

    @staticmethod
    def forward(ctx, t, world, dim):
        ctx.dim, ctx.size = dim % t.dim(), t.shape[dim]
        ctx.index = world.index("tp")
        return _all_gather(world.groups["tp"], world.backend, t, dim,
                           world.size("tp"), ctx.index)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
                .contiguous(), None, None)


class _PPermute(torch.autograd.Function):
    """A shift along an axis; the backward is the reverse shift."""

    @staticmethod
    def forward(ctx, t, world, axis, shift, cyclic):
        ctx.args = world, axis, -shift, cyclic
        return world.shift(t, axis, shift, cyclic)

    @staticmethod
    def backward(ctx, g):
        return ctx.args[0].shift(g, *ctx.args[1:]), None, None, None, None


class TrainWorld:
    """One rank's view of a training world over (pp, dp, sp, tp): its
    coordinates (``coords``), the tp ``shard`` its parameters are cut
    by (parallel/sharding.py), its device, the backend (the serving
    rule, ``choose_backend``), a group for each line of ranks it is on,
    and the collectives of the sharded forward and backward (the module
    doc). ``calls`` counts the collectives issued, by axis and kind."""

    def __init__(self, cfg: MeshConfig, rank: int, store,
                 device: torch.device, timeout_s: float):
        self.cfg = cfg
        self.rank = rank
        self.coords = train_coords(cfg, rank)
        self.shard = Shard(tp=cfg.tp, tp_rank=self.coords["tp"])
        self.device = rank_device(device, rank)
        self.backend = choose_backend(device, cfg.size)
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)
        timeout = datetime.timedelta(seconds=timeout_s)
        self.groups = {}
        for name, axes in TRAIN_GROUPS.items():
            if self.size(name) == 1:
                continue
            line = "/".join(f"{a}{i}" for a, i in self.coords.items()
                            if a not in axes)
            self.groups[name] = _group(self.backend, store,
                                       f"{name}:{line}", self.index(name),
                                       self.size(name), timeout)
        self.calls: Dict[str, int] = collections.Counter()

    def size(self, axis: str) -> int:
        """Ranks along an axis ("tp" and "world" alike: a training world
        has no ep, so the experts' combine is the tp sum) or the data
        axis (dp x sp)."""
        axis = "tp" if axis == "world" else axis
        n = 1
        for a in TRAIN_GROUPS[axis]:
            n *= getattr(self.cfg, a)
        return n

    def index(self, axis: str) -> int:
        """This rank's index along an axis (the data axis: dp-major)."""
        axis = "tp" if axis == "world" else axis
        i = 0
        for a in TRAIN_GROUPS[axis]:
            i = i * getattr(self.cfg, a) + self.coords[a]
        return i

    def reduce_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum t over an axis's ranks in place, outside autograd (the
        gradients' sum, the loss, the norm); a size-1 axis: t."""
        group = self.groups.get("tp" if axis == "world" else axis)
        if group is None:
            return t
        group.allreduce([t]).wait()
        self.calls[axis + ".all_reduce"] += 1
        return t

    def shift(self, t: torch.Tensor, axis: str, shift: int = 1,
              cyclic: bool = True) -> torch.Tensor:
        """Every rank's t moved `shift` places along an axis, outside
        autograd: cyclic, or not (a rank with no source gets zeros)."""
        group = self.groups.get(axis)
        if group is None:
            return t if cyclic else torch.zeros_like(t)
        n, i = self.size(axis), self.index(axis)
        dst, src = i + shift, i - shift
        if cyclic:
            dst, src = dst % n, src % n
        host = self.backend == "gloo" and t.is_cuda
        flat = (t.cpu() if host else t).contiguous().reshape(-1)
        m = flat.numel()
        send_sizes, recv_sizes = [0] * n, [0] * n
        if 0 <= dst < n:
            send_sizes[dst] = m
        else:
            flat = flat[:0]
        if 0 <= src < n:
            recv_sizes[src] = m
        out = torch.zeros(sum(recv_sizes), dtype=flat.dtype,
                          device=flat.device)
        group.alltoall_base(out, flat, recv_sizes, send_sizes).wait()
        self.calls[axis + ".shift"] += 1
        if not 0 <= src < n:
            return torch.zeros_like(t)
        return out.reshape(t.shape).to(t.device)

    # the collectives the forward calls (models/llama.py), through autograd

    def all_reduce(self, t: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        if self.size(axis) == 1:
            return t
        return _AllReduce.apply(t, self, axis)

    def copy_to_tp(self, t: torch.Tensor) -> torch.Tensor:
        if self.size("tp") == 1:
            return t
        return _CopyToTP.apply(t, self)

    def all_gather(self, t: torch.Tensor, dim: int,
                   axis: str = "tp") -> torch.Tensor:
        if self.size(axis) == 1:
            return t
        self.calls[axis + ".all_gather"] += 1
        return _AllGather.apply(t, self, dim)

    def ppermute(self, t: torch.Tensor, axis: str, shift: int = 1,
                 cyclic: bool = True) -> torch.Tensor:
        return _PPermute.apply(t, self, axis, shift, cyclic)

    def describe(self) -> dict:
        return {"backend": self.backend,
                **{a: getattr(self.cfg, a) for a in ("pp", "dp", "sp", "tp")},
                "ranks": device_map(self.device if self.device.type == "cpu"
                                    else torch.device("cuda"),
                                    self.cfg.size)}
