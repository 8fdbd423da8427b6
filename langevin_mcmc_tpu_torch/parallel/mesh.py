"""Chains sharded over devices (port of parallel/mesh.py).

The reference's only parallel axis is independent Markov chains (a thread
pool whose threads share the film through atomic splats). The port's mesh
is the ordered list of chain shards this process drives, each with its
device: shard i of rank r is global shard r * len(devices) + i. Every
shard's computation is independent; the only shared state is the film
(summed once at the end of a run), the bootstrap statistics and the PSS
cache (merged every few calls), see parallel/multihost.py.

A run of consecutive shards on one device is a group: it steps as one
make_mlt_step over its chains, with one film partition per shard
(film_shards), one generator and one cache. A list of repeated devices
(``['cpu'] * 4``) gives several film shards in one process, the CPU
analogue of the JAX package's virtual 8-device mesh.
"""

import dataclasses

import torch

from ..utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ChainMesh:
    devices: tuple   # torch.device of each of this process's shards
    rank: int        # this process
    world: int       # processes

    @property
    def num_shards(self):
        """Shards over every process (each drives len(devices))."""
        return self.world * len(self.devices)

    @property
    def first_shard(self):
        """Global index of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def groups(self):
        """(device, first local shard, shard count) of each run of
        consecutive local shards on one device."""
        out = []
        for i, d in enumerate(self.devices):
            if out and out[-1][0] == d:
                out[-1][2] += 1
            else:
                out.append([d, i, 1])
        return [tuple(g) for g in out]


def make_chain_mesh(devices=None):
    """The mesh of this process's shards: by default one, on the rank's
    device (multihost.rank_device)."""
    from . import multihost
    if devices is None:
        devices = [multihost.rank_device()]
    return ChainMesh(tuple(torch.device(d) for d in devices),
                     multihost.process_index(), multihost.process_count())


def shard_chains(mesh, tree):
    """Split the leading (chain) axis of every tensor of tree into equal
    per-shard slices and give each group its shards' slices, on its
    device (0-d tensors are copied whole). Returns one tree per group."""
    S = len(mesh.devices)

    def part(dev, first, count):
        def take(x):
            if x.ndim == 0:
                return x.to(dev)
            if x.shape[0] % S:
                raise ValueError(f'{x.shape[0]} chains do not split into '
                                 f'{S} shards')
            c = x.shape[0] // S
            return x[first * c:(first + count) * c].to(dev)
        return tree_map(take, tree)
    return [part(*g) for g in mesh.groups]


def replicate(mesh, tree):
    """One copy of tree per group, its tensors on the group's device (a
    dataclass with a ``device`` field, as SceneData, gets it set). A
    tensor held twice is copied once, so the copy keeps the tree's ties
    (a scene's BVH nodes and the tables packed from them, ops/bvh.py)."""
    def on(dev):
        moved = {}

        def to(x):
            if id(x) not in moved:
                moved[id(x)] = x.to(dev)
            return moved[id(x)]
        out = tree_map(to, tree)
        if dataclasses.is_dataclass(out) and any(
                f.name == 'device' for f in dataclasses.fields(out)):
            out = dataclasses.replace(out, device=dev)
        return out
    return [on(dev) for dev, _, _ in mesh.groups]
