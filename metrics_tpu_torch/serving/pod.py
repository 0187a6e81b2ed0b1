"""Where a mesh-placed :class:`~metrics_tpu_torch.serving.MetricBank`'s rows
live, and the host collectives that keep its processes in step
(counterpart of the pod layout of ``metrics_tpu/serving/bank.py``).

The JAX bank has one controller that addresses every device of the mesh.
The port runs one process per device, so a bank placed on a mesh is SPMD:
every process of the mesh builds it with the same arguments and makes the
same calls in the same order (the ``torch.distributed`` collective
contract). Each process keeps the whole host bookkeeping, identical
everywhere, and holds only its own rows:

* global slot ``s`` belongs to tenant shard ``s // shard_capacity``; the
  processes whose coordinates along ``tenant_axis`` (row-major over a tuple
  of axes) index that shard hold it, at local row ``s % shard_capacity``;
* a member state registered with ``add_state(sharding=)`` holds, on each of
  them, its ``torch.chunk`` slice over its own axis (``sharding/spec.py``).

:class:`PodLayout` answers where a row is, and runs the collectives over
the flat group of every process of the mesh:

* :meth:`PodLayout.exchange`: the rows of a list of slots, global, on every
  process, in one ``all_gather`` of one byte buffer per process (each
  process's owned rows of every leaf; the row count padded to a power of
  two, as the JAX gather pads its index). On gloo the buffer is staged
  through the host.
* :meth:`PodLayout.agree`: one small all-reduce of ``[first failing rank,
  digest, -digest]``, so that a call commits only where every process's
  part succeeded, every process raises the same error when one failed, and
  calls made out of step raise :class:`MetricsUserError` naming the first
  tenant that differs.
* :meth:`PodLayout.from_writer`: what mesh rank 0, the bank's one store
  writer, read from the store (or the error it raised), on every process.
"""
import hashlib
import pickle
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from metrics_tpu_torch.engine import bucketing as _bucketing
from metrics_tpu_torch.parallel import comm
from metrics_tpu_torch.sharding import spec as _shard_spec
from metrics_tpu_torch.utils.exceptions import MetricsUserError

__all__ = ["PodLayout"]

# the first-failing-rank slot of an agreement when no process failed
_NONE_FAILED = 1 << 62


def _align8(n: int) -> int:
    return (n + 7) & ~7


def _portable(err: BaseException, rank: int) -> BaseException:
    """``err`` as it can travel to the other processes: itself when it
    pickles and unpickles, else a :class:`MetricsUserError` with its text."""
    try:
        pickle.loads(pickle.dumps(err))
        return err
    except Exception:
        return MetricsUserError(f"{type(err).__name__} on mesh rank {rank}: {err}")


class PodLayout:
    """The placement of one bank over ``mesh``: tenant shards over
    ``tenant_axes`` (empty: one shard, every process holds every slot) and
    the member states' splits (``leaf_specs``: bank leaf name ->
    ``(PartitionSpec or None, global row shape)``)."""

    def __init__(
        self,
        mesh: Any,
        tenant_axes: Tuple[str, ...],
        shard_capacity: int,
        leaf_specs: Dict[str, Tuple[Any, Tuple[int, ...]]],
    ) -> None:
        names = _shard_spec.axis_names(mesh)
        self.mesh = mesh
        self.tenant_axes = tuple(tenant_axes)
        self.shard_capacity = int(shard_capacity)
        self.n_shards = 1
        for axis in self.tenant_axes:
            self.n_shards *= _shard_spec.axis_size(mesh, axis)
        # the flat group over every mesh axis (made once per mesh: a
        # collective of every process of the mesh)
        self.group = comm.axis_group(mesh, names)
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        #: mesh rank 0 alone reads and writes the bank's store
        self.writer = self.rank == 0
        grid = mesh.mesh.reshape(-1).tolist()
        shape = [int(n) for n in mesh.mesh.shape]
        self.coords: List[Dict[str, int]] = []
        for r in range(self.world):
            pos = grid.index(dist.get_global_rank(self.group, r))
            coord: Dict[str, int] = {}
            for axis, n in zip(reversed(names), reversed(shape)):
                coord[axis] = pos % n
                pos //= n
            self.coords.append(coord)
        self.shards = [self._shard_of(c) for c in self.coords]
        self.shard = self.shards[self.rank]
        self.leaf_specs = dict(leaf_specs)
        # every process's (offsets, local shape) of every leaf's row
        self.row_layouts: List[Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]] = []
        for coord in self.coords:
            per: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {}
            for name, (spec, row_shape) in self.leaf_specs.items():
                if spec is None:
                    per[name] = ((0,) * len(row_shape), tuple(row_shape))
                else:
                    lay = _shard_spec.layout_at(mesh, spec, tuple(row_shape), coord, name)
                    per[name] = (lay.offsets, lay.local_shape)
            self.row_layouts.append(per)
        # one source per distinct (shard, slices): replicas are not unpacked twice
        seen, self.sources = set(), []
        for r in range(self.world):
            key = (self.shards[r], tuple(sorted(self.row_layouts[r].items())))
            if key not in seen:
                seen.add(key)
                self.sources.append(r)

    def _shard_of(self, coord: Dict[str, int]) -> int:
        idx = 0
        for axis in self.tenant_axes:
            idx = idx * _shard_spec.axis_size(self.mesh, axis) + coord[axis]
        return idx

    @property
    def split(self) -> bool:
        """Whether any process holds less than every row: tenant shards, or
        a member state split over a mesh axis."""
        return self.n_shards > 1 or any(
            local != tuple(self.leaf_specs[n][1]) for per in self.row_layouts for n, (_, local) in per.items()
        )

    # -- slots -------------------------------------------------------------
    def shard_of_slot(self, slot: int) -> int:
        return slot // self.shard_capacity

    def owns(self, slot: int) -> bool:
        return slot // self.shard_capacity == self.shard

    def local_row(self, slot: int) -> int:
        return slot - self.shard * self.shard_capacity

    def local_value(self, name: str, row: torch.Tensor) -> torch.Tensor:
        """This process's slice of a global row of leaf ``name``."""
        offsets, local = self.row_layouts[self.rank][name]
        out = torch.as_tensor(row)
        for dim, (off, n) in enumerate(zip(offsets, local)):
            if n != out.shape[dim]:
                out = out.narrow(dim, off, n)
        return out

    # -- the read exchange ---------------------------------------------------
    def exchange(self, bank: Dict[str, torch.Tensor], slots: Sequence[int], names: Sequence[str]) -> Dict[str, torch.Tensor]:
        """The global rows of ``slots`` for the leaves ``names``, as host
        tensors ``[len(slots), *row shape]``, identical on every process:
        one ``all_gather`` of each process's owned rows (a collective every
        process of the mesh makes with the same arguments). ``bank`` is this
        process's resident leaves, indexed by local row."""
        slots = list(slots)
        names = sorted(names)
        owned = [[i for i, s in enumerate(slots) if self.shard_of_slot(s) == self.shards[r]] for r in range(self.world)]
        rows = _bucketing.next_pow2(max([len(o) for o in owned] + [1]))
        sizes = []
        for r in range(self.world):
            sizes.append(sum(_align8(rows * self._row_bytes(bank, r, n)) for n in names))
        width = _align8(max(sizes + [8]))
        device = next(iter(bank.values())).device
        mine = [self.local_row(slots[i]) for i in owned[self.rank]]
        parts: List[torch.Tensor] = []
        if mine:
            idx = torch.tensor(mine + [mine[0]] * (rows - len(mine)), dtype=torch.int64)
            if device.type == "cuda":
                idx = idx.pin_memory().to(device, non_blocking=True)
            for n in names:
                raw = bank[n].index_select(0, idx).reshape(-1).view(torch.uint8)
                parts.append(raw)
                pad = _align8(raw.numel()) - raw.numel()
                if pad:
                    parts.append(raw.new_zeros(pad))
        used = sum(p.numel() for p in parts)
        if used < width:
            parts.append(torch.zeros(width - used, dtype=torch.uint8, device=device))
        got = comm.exchange_bytes(torch.cat(parts), self.group)
        out = {
            n: torch.empty((len(slots),) + tuple(self.leaf_specs[n][1]), dtype=bank[n].dtype) for n in names
        }
        for r in self.sources:
            if not owned[r]:
                continue
            at = torch.tensor(owned[r], dtype=torch.int64)
            off = 0
            for n in names:
                offsets, local = self.row_layouts[r][n]
                nbytes = rows * self._row_bytes(bank, r, n)
                block = got[r, off : off + nbytes].view(bank[n].dtype).reshape((rows,) + tuple(local))
                off += _align8(nbytes)
                target = out[n]
                for dim, (o, k) in enumerate(zip(offsets, local)):
                    target = target.narrow(dim + 1, o, k)
                target.index_copy_(0, at, block[: len(owned[r])])
        return out

    def _row_bytes(self, bank: Dict[str, torch.Tensor], rank: int, name: str) -> int:
        n = bank[name].element_size()
        for k in self.row_layouts[rank][name][1]:
            n *= int(k)
        return n

    # -- agreement -----------------------------------------------------------
    def agree(
        self,
        err: Optional[BaseException],
        digest: Optional[bytes] = None,
        describe: Optional[Callable[[], Tuple[List[str], List[Tuple]]]] = None,
        what: str = "",
    ) -> None:
        """One all-reduce: raise on every process when any process's part
        failed (the first failing rank's error; that process raises its
        own), or when the processes' ``digest`` differs (the calls were made
        out of step: :class:`MetricsUserError` naming the first tenant of
        ``describe()`` — ``(request tenants, bookkeeping rows)`` — that
        differs between processes)."""
        h = int.from_bytes(hashlib.sha1(digest or b"").digest()[:7], "big")
        first, lo, neg_hi = comm.host_all_reduce(
            [self.rank if err is not None else _NONE_FAILED, h, -h], "min", self.group
        )
        if first != _NONE_FAILED:
            shared = comm.broadcast_object(_portable(err, self.rank) if self.rank == first else None, first, self.group)
            if err is not None and self.rank == first:
                raise err
            raise shared
        if digest is not None and lo != -neg_hi:
            views = comm.all_gather_object(describe() if describe is not None else ([], []), self.group)
            raise MetricsUserError(self._divergence(views, what))

    def _divergence(self, views: List[Tuple[List[str], List[Tuple]]], what: str) -> str:
        base = views[0]
        for part, label in ((0, "the requests' tenants"), (1, "the bank's slots and counts")):
            for r, view in enumerate(views[1:], start=1):
                a, b = base[part], view[part]
                for i in range(max(len(a), len(b))):
                    x = a[i] if i < len(a) else None
                    y = b[i] if i < len(b) else None
                    if x != y:
                        tenant = (x if x is not None else y)
                        tenant = tenant[0] if isinstance(tenant, tuple) else tenant
                        return (
                            f"{what}: the processes of the mesh are out of step; {label} differ first at tenant"
                            f" {tenant} (mesh rank 0: {x!r}, mesh rank {r}: {y!r}). Every process of the mesh must"
                            " make the same bank calls, with the same tenants, in the same order."
                        )
        return f"{what}: the processes of the mesh are out of step (their bookkeeping digests differ)."

    def broadcast(self, obj: Any, src: int) -> Any:
        """``obj`` of the process at mesh rank ``src``, on every process."""
        return comm.broadcast_object(obj if self.rank == src else None, src, self.group)

    def from_writer(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` run on mesh rank 0 (the store's one reader), its result
        or its error on every process."""
        err: Optional[BaseException] = None
        msg: Optional[Tuple[str, Any]] = None
        if self.writer:
            try:
                msg = ("ok", fn())
            except Exception as e:
                err, msg = e, ("err", _portable(e, self.rank))
        kind, value = comm.broadcast_object(msg, 0, self.group)
        if err is not None:
            raise err
        if kind == "err":
            raise value
        return value
