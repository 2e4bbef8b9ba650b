"""Process groups and the (dp, tp) grid on ``torch.distributed``.

Counterpart of ``e4t_diffusion_tpu/parallel/mesh.py``. The JAX package
places arrays on a device mesh and lets XLA insert the collectives; here
one process drives one card (``torchrun --nproc_per_node N -m
e4t_diffusion_torch.<cli>``) and the collectives are written out:

- data parallel (``dp``): each rank trains on its own batch; on update
  calls the trainables' gradients are averaged over dp in f32
  (``Mesh.reduce_gradients``); in serving each rank samples its rows of
  the batch and the images are gathered (``Mesh.gather_rows``);
- ZeRO-1: AdamW's state sharded over dp (``training/train_step
  .make_optimizer``, torch's ``ZeroRedundancyOptimizer``);
- tensor parallel (``tp``): the UNet's attention and feed-forward sites
  split Megatron's way (``apply_tensor_parallel``): q/k/v and the GEGLU
  projection by output rows, ``to_out.0`` and ``ff.net.2`` by input
  columns, each rank holding ``heads / tp`` heads, so the flash kernels run
  on the local heads with no collective. A column site's input passes
  ``copy_to_tp`` (identity forward, gradient summed over tp), a row site's
  partial product ``reduce_from_tp`` (summed over tp in f32, identity
  backward). ``proj_in`` / ``proj_out`` stay replicated: the LayerNorms and
  residuals between them need the full channel width.

Rank r sits at (r // tp, r % tp) of the grid, as the JAX package reshapes
its devices to (n // tp, tp). Without a process group ``get_mesh`` returns
the one-process mesh, on which every collective is skipped (as is each
collective over a grid axis of size 1). NCCL on the
card; gloo only when the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

# what torchrun exports to every process it starts
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK")
# gradient all-reduce buckets: at most this many f32 elements (256 MiB)
_BUCKET_ELEMS = 1 << 26
# how long a rank waits in a ``patient_group`` collective for the others:
# there a person, not the work, sets the pace (the world group's own
# timeout, 10 minutes under NCCL, would abort the waiting ranks)
PATIENT_TIMEOUT = datetime.timedelta(days=7)


def maybe_initialize_distributed(device: torch.device) -> torch.device:
    """Join the process group a ``torchrun`` launch describes and return
    the device this process drives: ``cuda:LOCAL_RANK`` (made current
    before the NCCL group forms) on the card, ``device`` on the CPU (gloo).
    A process started without torchrun's variables is a one-process run:
    nothing happens. Some of them set and not all raises, naming the
    missing ones, so a launch that asked for several processes never
    carries on as one."""
    present = [k for k in TORCHRUN_ENV if k in os.environ]
    if not present:
        return device
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"[mesh] {', '.join(present)} set but not {', '.join(missing)}: "
            f"launch with torchrun, or set all of {', '.join(TORCHRUN_ENV)}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://", rank=rank,
                                world_size=world)
    return device


def initialize(rank: int, world: int, device: torch.device,
               store: Optional[dist.Store] = None,
               init_method: Optional[str] = None) -> None:
    """Form the process group from explicit arguments (tests, in-process
    launches): NCCL for a CUDA ``device``, gloo for the CPU; ``store`` (a
    ``FileStore``, say) or ``init_method`` (``tcp://host:port``)."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=store, init_method=init_method,
                            rank=rank, world_size=world)


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """What a tensor-parallel site needs: its group, size and rank."""
    group: Any
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (dp, tp) grid this process sits in. ``world_group`` None: one
    process and no process group, every collective skipped."""
    dp: int = 1
    tp: int = 1
    rank: int = 0
    world_group: Any = None
    dp_group: Any = None
    tp_group: Any = None

    @property
    def distributed(self) -> bool:
        return self.world_group is not None

    @property
    def world(self) -> int:
        return self.dp * self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def tp_site(self) -> TPGroup:
        return TPGroup(self.tp_group, self.tp, self.tp_rank)

    def describe(self) -> str:
        return (f"dp={self.dp} x tp={self.tp} (rank {self.rank} of "
                f"{self.world}" + (", no process group)"
                                   if not self.distributed else ")"))

    # ---- collectives (skipped without a process group) -----------------

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier(group=self.world_group)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                   group: Any = None) -> torch.Tensor:
        """In place over ``group`` (default: every rank); returns ``t``."""
        if self.distributed:
            dist.all_reduce(t, op=op, group=(self.world_group if group is None
                                             else group))
        return t

    def any_rank(self, flag: bool, device: torch.device) -> bool:
        """True on every rank when ``flag`` is True on any (a MAX
        all-reduce): the ranks then stop at the same step."""
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
        return bool(self.all_reduce(t, dist.ReduceOp.MAX).item())

    def dp_mean(self, values: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Scalars averaged over dp (the logged losses)."""
        if self.dp == 1 or not values:
            return values
        keys = sorted(values)
        t = torch.stack([values[k].float() for k in keys])
        self.all_reduce(t, group=self.dp_group).div_(self.dp)
        return dict(zip(keys, t.unbind()))

    def broadcast_object(self, obj: Any, group: Any = None) -> Any:
        """Rank 0's ``obj`` on every rank (pickled over ``group``, by
        default the world group)."""
        if not self.distributed:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=(
            self.world_group if group is None else group))
        return box[0]

    def patient_group(self) -> Any:
        """A gloo group over the world group's ranks whose collectives wait
        PATIENT_TIMEOUT (None without a process group): for the ranks that
        wait on rank 0 while it waits on a person. Every rank calls it, in
        one order, as it would ``dist.new_group``."""
        if not self.distributed:
            return None
        return dist.new_group(dist.get_process_group_ranks(self.world_group),
                              timeout=PATIENT_TIMEOUT, backend="gloo")

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order."""
        if not self.distributed:
            return [obj]
        out: List[Any] = [None] * self.world
        dist.all_gather_object(out, obj, group=self.world_group)
        return out

    def reduce_gradients(self, params: Sequence[torch.Tensor],
                         tp_partial: Sequence[torch.Tensor] = ()) -> None:
        """Each ``.grad`` averaged over dp (summed in f32, then divided by
        dp); the grads of ``tp_partial`` first summed over tp (a tensor
        whose tp ranks each saw only their shard's share). An axis of size
        1 is skipped."""
        if self.tp > 1:
            _all_reduce_grads([p for p in tp_partial if p.grad is not None],
                              self.tp_group)
        if self.dp > 1:
            _all_reduce_grads([p for p in params if p.grad is not None],
                              self.dp_group, divide=self.dp)

    def global_grad_norm(self, params: Sequence[torch.Tensor],
                         sharded: Sequence[torch.Tensor]) -> torch.Tensor:
        """The L2 norm of every gradient, each tp-sharded tensor's shards
        counted once across tp and each replicated tensor once (without
        shards, ``clip_grad_norm_``'s norm)."""
        sharded_ids = {id(p) for p in sharded}
        norms = list(torch._foreach_norm(
            [p.grad for p in params if id(p) not in sharded_ids]))
        if sharded:
            sq = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
                [p.grad for p in sharded]))) ** 2
            if self.tp > 1:
                self.all_reduce(sq, group=self.tp_group)
            norms.append(sq.sqrt())
        return torch.linalg.vector_norm(torch.stack(norms))

    # ---- data parallel rows --------------------------------------------

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a batch split over dp."""
        n = local_batch_slice(global_batch, self)
        return slice(self.dp_rank * n, (self.dp_rank + 1) * n)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every dp rank's rows, concatenated in rank order."""
        if not self.distributed or self.dp == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.dp)]
        dist.all_gather(parts, x.contiguous(), group=self.dp_group)
        return torch.cat(parts)


def consolidated_state_dict(optimizer: torch.optim.Optimizer
                            ) -> Optional[dict]:
    """The optimizer's state in the unsharded AdamW layout. Under ZeRO-1
    every rank of its group takes part and the first rank of the group
    gets the state (the others None)."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    if not isinstance(optimizer, ZeroRedundancyOptimizer):
        return optimizer.state_dict()
    first = dist.get_global_rank(optimizer.process_group, 0)
    optimizer.consolidate_state_dict(to=first)
    return optimizer.state_dict() if dist.get_rank() == first else None


def get_mesh(tp: int = 1) -> Mesh:
    """The (dp, tp) grid over the process group: dp = world / tp. Without a
    process group: the one-process mesh (tp must be 1). The world size must
    divide by tp."""
    if not (dist.is_available() and dist.is_initialized()):
        if tp != 1:
            raise ValueError(
                f"tensor parallelism over {tp} ranks needs {tp} processes: "
                f"launch with torchrun --nproc_per_node {tp} (or a multiple)")
        return Mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    if tp < 1 or world % tp:
        raise ValueError(f"{world} processes not divisible by tp={tp}")
    dp = world // tp

    def group(ranks):
        # every rank creates every group, in one order
        return dist.group.WORLD if len(ranks) == world else dist.new_group(
            ranks)

    tp_groups = [group(list(range(i * tp, (i + 1) * tp))) for i in range(dp)]
    dp_groups = [group(list(range(j, world, tp))) for j in range(tp)]
    return Mesh(dp=dp, tp=tp, rank=rank, world_group=dist.group.WORLD,
                dp_group=dp_groups[rank % tp], tp_group=tp_groups[rank // tp])


def local_batch_slice(global_batch: int, mesh: Mesh) -> int:
    """Per-rank batch of a global batch split over dp (the JAX package's
    per-process slice); a batch that dp does not divide raises, naming
    dp."""
    if global_batch % mesh.dp:
        raise ValueError(f"batch ({global_batch}) not divisible by the dp "
                         f"mesh axis ({mesh.dp})")
    return global_batch // mesh.dp


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of every tensor whose leading axis dp divides; 0-dim
    and indivisible entries are kept whole (replicated)."""
    out = {}
    for k, v in batch.items():
        if (isinstance(v, torch.Tensor) and v.dim() >= 1
                and v.shape[0] % mesh.dp == 0):
            v = v[mesh.rows(v.shape[0])]
        out[k] = v
    return out


def _all_reduce_grads(params: Sequence[torch.Tensor], group: Any,
                      divide: int = 1) -> None:
    """Sum ``.grad`` over ``group`` in f32 buckets, then divide."""
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        flat = torch.cat([p.grad.reshape(-1).float() for p in bucket])
        dist.all_reduce(flat, group=group)
        if divide != 1:
            flat.div_(divide)
        offset = 0
        for p in bucket:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n

    for p in params:
        bucket.append(p)
        size += p.grad.numel()
        if size >= _BUCKET_ELEMS:
            flush()
            bucket, size = [], 0
    if bucket:
        flush()


# ---- tensor parallel --------------------------------------------------------

class _CopyToTP(torch.autograd.Function):
    """A column site's input: identity forward, gradient summed over tp."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    """A row site's partial product: summed over tp forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    return _CopyToTP.apply(x, tp.group)


def row_parallel(linear: nn.Linear, x: torch.Tensor, tp: TPGroup
                 ) -> torch.Tensor:
    """A row-parallel linear site on this rank's input columns ``x``: the
    partial products (int8 while ``quant.int8_sites`` holds the site) summed
    over tp in f32, cast to x's type, then the bias once."""
    from e4t_diffusion_torch.ops import quant

    y = _ReduceFromTP.apply(quant.linear_partial(linear, x), tp.group)
    y = y.to(x.dtype)
    if linear.bias is not None:
        y = y + linear.bias.to(x.dtype)
    return y


# how each split parameter is cut: "col" by output rows (dim 0), "row" by
# input columns (dim 1), "geglu" the GEGLU projection's hidden and gate
# halves each by rows
_SPLITS = ("col", "row", "geglu")


def _split(t: torch.Tensor, kind: str, size: int, rank: int) -> torch.Tensor:
    if kind == "col":
        return t.chunk(size, dim=0)[rank]
    if kind == "row":
        return t.chunk(size, dim=1)[rank]
    hidden, gate = t.chunk(2, dim=0)
    return torch.cat([hidden.chunk(size, dim=0)[rank],
                      gate.chunk(size, dim=0)[rank]])


def _join(parts: Sequence[torch.Tensor], kind: str) -> torch.Tensor:
    if kind == "col":
        return torch.cat(parts, dim=0)
    if kind == "row":
        return torch.cat(parts, dim=1)
    halves = [p.chunk(2, dim=0) for p in parts]
    return torch.cat([h for h, _ in halves] + [g for _, g in halves])


def tensor_parallel_specs(unet: nn.Module, tp: int) -> Dict[str, str]:
    """{parameter name: "col" | "row" | "geglu"} of the UNet's split
    parameters at degree ``tp`` (the JAX package's rules): q/k/v and the
    GEGLU projection column-parallel, ``to_out.0`` and ``ff.net.2``
    row-parallel, everything else replicated. An attention module whose
    head count tp does not divide, or a feed-forward whose width it does
    not divide, stays whole."""
    from e4t_diffusion_torch.models.unet import Attention, FeedForward

    specs: Dict[str, str] = {}
    if tp == 1:
        return specs
    for name, m in unet.named_modules():
        if isinstance(m, Attention) and m.heads % tp == 0:
            for proj in ("to_q", "to_k", "to_v"):
                specs[f"{name}.{proj}.weight"] = "col"
            specs[f"{name}.to_out.0.weight"] = "row"
        elif isinstance(m, FeedForward) and (
                m.net[0].proj.out_features // 2) % tp == 0:
            specs[f"{name}.net.0.proj.weight"] = "geglu"
            specs[f"{name}.net.0.proj.bias"] = "geglu"
            specs[f"{name}.net.2.weight"] = "row"
    return specs


def apply_tensor_parallel(unet: nn.Module, mesh: Mesh) -> Dict[str, str]:
    """Split the UNet's transformer sites over tp in place: each split
    parameter becomes this rank's shard (``tensor_parallel_specs``), each
    split attention module keeps ``heads / tp`` heads, and the split
    modules get ``tp`` (their ``TPGroup``), which routes their forward
    through the collectives. Records the specs as ``unet.tp_specs``; a
    no-op at tp=1. A tp that splits no site raises. Load the UNet's weights
    before, not after."""
    from e4t_diffusion_torch.models.unet import Attention, FeedForward

    specs = tensor_parallel_specs(unet, mesh.tp)
    if not specs:
        if mesh.tp > 1:
            raise ValueError(
                f"tp={mesh.tp} divides no attention site's head count and "
                f"no feed-forward width: nothing would be split")
        return specs
    site = mesh.tp_site()
    params = dict(unet.named_parameters())
    with torch.no_grad():
        for name, kind in specs.items():
            module_name, leaf = name.rsplit(".", 1)
            module = unet.get_submodule(module_name)
            old = params[name]
            new = _split(old.detach(), kind, mesh.tp, mesh.tp_rank)
            setattr(module, leaf, nn.Parameter(
                new.contiguous(), requires_grad=old.requires_grad))
            if leaf == "weight":
                module.out_features, module.in_features = new.shape
    for name, m in unet.named_modules():
        if isinstance(m, Attention) and f"{name}.to_q.weight" in specs:
            m.heads //= mesh.tp
            m.tp = site
        elif isinstance(m, FeedForward) and \
                f"{name}.net.2.weight" in specs:
            m.tp = site
    unet.tp_specs = specs
    unet.tp_site = site
    return specs


def local_shard(unet: nn.Module, name: str, full: torch.Tensor
                ) -> torch.Tensor:
    """This rank's shard of a full-layout tensor shaped like the UNet
    parameter ``name`` (an offset, a LoRA delta); unchanged where the
    parameter is not split."""
    kind = getattr(unet, "tp_specs", {}).get(name)
    if kind is None:
        return full
    return _split(full, kind, unet.tp_site.size, unet.tp_site.rank)


def full_state_dict(unet: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The UNet's state dict in the unsplit layout (every tp rank takes
    part: the shards are all-gathered over tp)."""
    state = unet.state_dict()
    for name, kind in getattr(unet, "tp_specs", {}).items():
        local = state[name].contiguous()
        parts = [torch.empty_like(local) for _ in range(mesh.tp)]
        dist.all_gather(parts, local, group=mesh.tp_group)
        state[name] = _join(parts, kind)
    return state


def is_row_split(unet: nn.Module, site_name: str) -> bool:
    """True for an int8 site (a module name) that is row-parallel."""
    return getattr(unet, "tp_specs", {}).get(f"{site_name}.weight") == "row"


def kernel_scale_reducer(unet: nn.Module
                         ) -> Optional[Callable[[str, torch.Tensor],
                                                torch.Tensor]]:
    """For ``quant.quantize_params`` on a UNet split over tp: a row-parallel
    site's per-output-channel weight abs-max is the MAX over tp of its
    shards', so its int8 scales equal those of the whole kernel (column
    shards keep whole rows). None for an unsplit UNet."""
    site = getattr(unet, "tp_site", None)
    if site is None:
        return None

    def reduce(site_name: str, amax: torch.Tensor) -> torch.Tensor:
        if is_row_split(unet, site_name):
            amax = amax.contiguous().clone()
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=site.group)
        return amax

    return reduce


def channel_scale_shard(unet: nn.Module
                        ) -> Optional[Callable[[str, torch.Tensor],
                                               torch.Tensor]]:
    """For ``quant.quantize_params`` on a UNet split over tp: a
    row-parallel site's per-input-channel activation scales (``"sac"``,
    computed on the whole calibrated vector, so its ``max_c`` term is the
    unsplit one's) cut to this rank's input columns by the split of its
    weight; a column-split or replicated site keeps the whole vector. None
    for an unsplit UNet."""
    if getattr(unet, "tp_site", None) is None:
        return None

    def shard(site_name: str, sac: torch.Tensor) -> torch.Tensor:
        if not is_row_split(unet, site_name):
            return sac
        return local_shard(unet, f"{site_name}.weight", sac[None])[0]

    return shard


def reduce_calibration(amax: Dict[str, Dict[str, torch.Tensor]],
                       unet: Optional[nn.Module], mesh: Mesh) -> None:
    """Calibrated activation ranges made the same on every rank, in place:
    each site's abs-max the MAX over all ranks (dp rows and, at a
    row-parallel site, tp columns), its per-channel abs-max the MAX over
    dp, gathered over tp at a row-parallel site into the unsplit layout."""
    if not mesh.distributed:
        return
    for name in sorted(amax):
        site = amax[name]
        mesh.all_reduce(site["amax"], dist.ReduceOp.MAX)
        if "amax_c" in site:
            mesh.all_reduce(site["amax_c"], dist.ReduceOp.MAX, mesh.dp_group)
            if unet is not None and is_row_split(unet, name):
                local = site["amax_c"].contiguous()
                parts = [torch.empty_like(local) for _ in range(mesh.tp)]
                dist.all_gather(parts, local, group=mesh.tp_group)
                site["amax_c"] = torch.cat(parts)
