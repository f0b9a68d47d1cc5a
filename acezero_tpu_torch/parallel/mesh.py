"""Device mesh and the collectives of the data-parallel paths.

Counterpart of acezero_tpu/parallel/mesh.py: a 1-D `data` mesh whose axis
carries the patch-buffer rows and the training batch during mapping, and
the frame axis during registration; parameters are replicated (the scene
head is about 4 MB). In the JAX package XLA inserts the collectives from
sharding annotations (GSPMD). Here one process drives every device of the
mesh and the collectives are explicit tensor moves:
  - `shard_rows` / `replicate` place a tree, as `device_put` with a
    sharding does; a sharded or replicated tree is a list holding one tree
    per mesh device, index d on `mesh.devices[d]`;
  - `gather_rows` is the cross-shard batch gather: global row indices in,
    the batch split by position over the mesh out, bit-equal to indexing
    the unsharded buffer, with no host sync;
  - `reduce_sum` is the gradient (and loss) all-reduce onto one device, in
    device order so that the sum does not depend on timing;
  - `broadcast_` copies the primary's tree into the replicas in place.

A mesh may name one device more than once (`make_mesh(devices=["cpu"] *
4)`): a logical mesh, which runs the sharded code paths on one device (the
CPU tests, and `chip_smoke.py` on one card). There is no fallback: without
CUDA `make_mesh` raises unless the caller names the devices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

DATA_AXIS = "data"  # the mesh's one axis, as the JAX package names it


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along the `data` axis; `devices[0]` is
    the primary, where the state, the optimizer and the host's draws live."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        return self.devices[0]


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D `data` mesh over `devices` (which may repeat a device: a logical
    mesh), or over the first `n_devices` visible cards (all by default; a
    larger count is clamped, as slicing `jax.devices()` is)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=[...] for a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices))


def _map(fn, *trees):
    """`fn` over the tensor leaves of trees of one structure (dicts, lists,
    tuples); other leaves are taken from the first tree."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(tr[k] for tr in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, *xs) for xs in zip(*trees))
    if torch.is_tensor(t):
        return fn(*trees)
    return t


def _leaves(tree) -> list:
    # dicts in sorted key order: trees rebuilt by the optimizer may list
    # their keys in another order than the tree they were copied from
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    # asynchronous only towards a card: a copy to the host must be complete
    # when the host reads it
    return x.to(device, non_blocking=device.type == "cuda")


def _copy_to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of `x` on `device`, never an alias (`.to` of a tensor already
    there returns the tensor itself)."""
    return x.clone() if x.device == device else _to(x, device)


def shard_rows(tree, mesh: Mesh) -> list:
    """Split the leading (row) axis of every tensor of the tree into
    `mesh.size` equal contiguous blocks, block d on device d."""
    n = mesh.size
    for x in _leaves(tree):
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split into {n} equal shards; truncate them first")
    return [_map(lambda x, d=d: _copy_to(x[d * (x.shape[0] // n):(d + 1) * (x.shape[0] // n)], dev), tree)
            for d, dev in enumerate(mesh.devices)]


def replicate(tree, mesh: Mesh) -> list:
    """One copy of the tree per mesh device (a copy on the tree's own device
    too, so that updating a replica never writes into the original)."""
    return [_map(lambda x, dev=dev: _copy_to(x, dev), tree) for dev in mesh.devices]


def broadcast_(replicas: list, tree) -> None:
    """Copy `tree` into every replica in place."""
    for rep in replicas:
        for dst, src in zip(_leaves(rep), _leaves(tree)):
            if dst is not src:
                dst.copy_(src, non_blocking=True)


def gather_rows(shards: list, idx: torch.Tensor, mesh: Mesh) -> list:
    """The batch `buffer[idx]` of a row-sharded buffer, split by position:
    part d holds positions `torch.tensor_split(arange(B), mesh.size)[d]` and
    lies on device d.

    Each shard gathers at clamped local indices on its own device; part d
    keeps, at each position, the row of the shard that owns the index
    (`torch.where`, so a non-finite row of another shard cannot leak in, as
    a product with the mask would let NaN through). Every index lands in
    exactly one shard, so the result is bit-equal to indexing the whole
    buffer. Nothing is read back to the host."""
    R = _leaves(shards[0])[0].shape[0]
    idx = idx.to(torch.int64)
    parts = []
    for (lo, hi), dev in zip(split_positions(idx.shape[0], mesh), mesh.devices):
        idx_d = _to(idx[lo:hi], dev)
        part = None
        for s, (shard, dev_s) in enumerate(zip(shards, mesh.devices)):
            local = idx_d - s * R
            at = _to(local.clamp(0, R - 1), dev_s)
            rows = _map(lambda x: _to(x[at], dev), shard)
            if part is None:
                part = rows
                continue
            own = (local >= 0) & (local < R)
            part = _map(lambda new, old: torch.where(own.reshape((-1,) + (1,) * (new.dim() - 1)), new, old),
                        rows, part)
        parts.append(part)
    return parts


def split_positions(n: int, mesh: Mesh) -> list[tuple[int, int]]:
    """[lo, hi) of each device's part of n positions, as `torch.tensor_split`
    splits them (the first n % size parts one longer)."""
    base, extra = divmod(n, mesh.size)
    out, lo = [], 0
    for d in range(mesh.size):
        hi = lo + base + (d < extra)
        out.append((lo, hi))
        lo = hi
    return out


def reduce_sum(trees: list, device):
    """The sum of per-device trees on `device`, added in device order
    (trees[0] + trees[1] + ...): the same bits whatever the devices'
    timing. One tree comes back as it is (moved to `device`)."""
    dev = _device(device)
    return _map(lambda *xs: _sum_in_order(xs, dev), *trees)


def _sum_in_order(xs, dev):
    acc = _to(xs[0], dev)
    for x in xs[1:]:
        acc = acc + _to(x, dev)
    return acc
