"""The mesh's two collectives as copies between the shards' buffers.

The counterparts of the tiled `lax.all_to_all` and `lax.all_gather` inside
the JAX package's per-device bodies (parallel/tp.py:61-83,
poly/ntt.py:205-229). One process drives every shard (parallel/mesh.py), so
a collective is a set of `copy_` calls: between two cards a peer copy (over
NVLink where the cards have it), between two shards on one card a device
copy. Each is asynchronous on the card's current stream, and PyTorch orders
a copy between two cards against both cards' current streams (an event each
way), so the copies wait for the kernels that wrote their sources and the
kernels that read their destinations wait for them: every kernel wrapper
launches on its operands' device's current stream (`_cuda.on_device`).

`all_to_all.copies` and `gather.copies` count the copies issued.
"""

from __future__ import annotations

import torch

from .. import _cuda


def all_to_all(blocks: list[torch.Tensor], split_axis: int, concat_axis: int,
               out: list[torch.Tensor] | None = None) -> list[torch.Tensor]:
    """JAX's tiled all_to_all over D shards, block i on shard i: block i is
    cut along `split_axis` into D equal chunks, chunk j goes to shard j, and
    shard j lays the D chunks it receives along `concat_axis` in source
    order (for every pair of axes, `split_axis == concat_axis` included).

    With two axes, a block may be shorter along `concat_axis` than the first
    (the commit's last column blocks, which hold pad columns, zero
    polynomials, neither transformed nor sent): it sends what it has.
    `out`: the D receiving buffers (views allowed); a buffer shorter along
    `concat_axis` than the D chunks keeps what fits, cut at its end (the pad
    columns dropped). Without it each shard's buffer is allocated on its
    block's device."""
    d = len(blocks)
    size = blocks[0].shape[split_axis]
    ragged = split_axis != concat_axis
    if size % d or any(b.shape[split_axis] != size if ragged else b.shape != blocks[0].shape
                       for b in blocks):
        raise ValueError(f"{d} blocks of {[tuple(b.shape) for b in blocks]}: all_to_all "
                         f"takes D blocks of one size along axis {split_axis}, D dividing it")
    size //= d
    chunk = blocks[0].shape[concat_axis] if ragged else size
    if out is None:
        shape = list(blocks[0].shape)
        shape[split_axis] = size
        shape[concat_axis] = chunk * d
        out = [torch.empty(shape, dtype=b.dtype, device=b.device) for b in blocks]
    for j, dst in enumerate(out):
        with _cuda.on_device(dst.device):
            for i, src in enumerate(blocks):
                rows = min(src.shape[concat_axis] if ragged else chunk,
                           dst.shape[concat_axis] - i * chunk)
                if rows <= 0:
                    break
                piece = src.narrow(split_axis, j * size, size).narrow(concat_axis, 0, rows)
                dst.narrow(concat_axis, i * chunk, rows).copy_(piece, non_blocking=True)
                all_to_all.copies += 1
    return out


def gather(blocks: list[torch.Tensor], out: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """JAX's tiled all_gather onto one buffer: the blocks laid along `axis`
    in shard order into `out` (on any device), cut at its end as in
    `all_to_all`. Returns `out`."""
    start = 0
    with _cuda.on_device(out.device):
        for block in blocks:
            rows = min(block.shape[axis], out.shape[axis] - start)
            if rows <= 0:
                break
            out.narrow(axis, start, rows).copy_(block.narrow(axis, 0, rows), non_blocking=True)
            gather.copies += 1
            start += block.shape[axis]
    return out


def scatter(x: torch.Tensor, devices: list[torch.device], axis: int = 0) -> list[torch.Tensor]:
    """x cut along `axis` into len(devices) equal contiguous blocks, block i
    on devices[i] (a view where it is already there)."""
    d = len(devices)
    if x.shape[axis] % d:
        raise ValueError(f"{x.shape[axis]} rows do not split over {d} shards")
    return [block.to(dev, non_blocking=True)
            for block, dev in zip(x.chunk(d, dim=axis), devices)]


all_to_all.copies = 0
gather.copies = 0
