"""The (dp, tp) rank grid for sharded detection (counterpart of
`linemod_tpu/parallel/mesh.py`).

Each `torch.distributed` rank owns one device. The first n ranks of the
world are laid out as JAX lays out its devices, `arange(n).reshape(dp,
n // dp)`: a row is one `tp` group (the ranks that split the template bank
and the planes' bands of one frame), a column one `dp` group (the ranks
that hold the same template shard of different frames). Ranks past n get a
mesh with no groups and take no part.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in the (dp, tp) grid. `tp_group` is its row,
    `dp_group` its column, `group` all n ranks of the mesh; all three are
    None (and the indexes -1) on a rank outside the mesh."""

    dp: int
    tp: int
    dp_index: int
    tp_index: int
    tp_group: object
    dp_group: object
    group: object

    @property
    def active(self) -> bool:
        return self.dp_index >= 0


def make_mesh(n_devices: int | None = None, dp: int = 1) -> Mesh:
    """Mesh with axes (dp, tp) over the first n_devices ranks of the world
    (all of them by default); tp = n_devices / dp.

    Every rank of the world must call this, in the same order as its peers:
    `dist.new_group` is collective over the whole world, members or not, so
    a rank that skipped one would leave the others waiting."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 0 < n <= world:
        raise ValueError(f"n_devices {n} outside 1..{world}")
    if n % dp:
        raise ValueError(f"dp {dp} must divide the device count {n}")
    grid = np.arange(n).reshape(dp, n // dp)
    me = dist.get_rank()
    rows = [dist.new_group([int(r) for r in row]) for row in grid]
    cols = [dist.new_group([int(r) for r in col]) for col in grid.T]
    group = dist.new_group(list(range(n)))
    if me >= n:
        return Mesh(dp, n // dp, -1, -1, None, None, None)
    i, j = divmod(me, n // dp)
    return Mesh(dp, n // dp, i, j, rows[i], cols[j], group)
