"""Rank-split execution for the offline tools (port of
vfm_vae_tpu/parallel/serving.py).

The reference's tools run under torchrun, one process per GPU, each taking
`items[rank::world]` of the work list (DistributedSampler over the image
list in reconstruct, safetensors files by rank in decode, tar shards by
rank in prefetch). The port keeps that layout: `process_shard` reads
torchrun's RANK and WORLD_SIZE (0 and 1 without them), and each process
drives its own card. The tools need no collective, so no process group is
made.

The JAX package pads every batch to one fixed block (`ShardedFn`) so that
XLA compiles a single program for full and tail batches. Eager torch has no
compile to share, so `batched` hands out the tail batch at its own size and
nothing is padded or trimmed.
"""

from __future__ import annotations

import itertools
import os
from typing import Iterable, Iterator, List, Sequence, Tuple


def rank_and_world() -> Tuple[int, int]:
    """(RANK, WORLD_SIZE) from torchrun's environment; (0, 1) without it."""
    rank, world = int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"RANK={rank} WORLD_SIZE={world} is not a valid process split")
    return rank, world


def process_shard(items: Sequence) -> list:
    """This process's share of a work list: items[rank::world]."""
    rank, world = rank_and_world()
    return list(items)[rank::world]


def batched(items: Iterable, size: int) -> Iterator[List]:
    """Consecutive lists of `size` items; the last holds what is left."""
    if size < 1:
        raise ValueError(f"batch size {size} < 1")
    it = iter(items)
    while True:
        chunk = list(itertools.islice(it, size))
        if not chunk:
            return
        yield chunk
