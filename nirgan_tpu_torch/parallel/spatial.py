"""Spatial sharding of one large tile over ``torch.distributed``,
counterpart of ``nirgan_tpu/parallel/spatial.py``.

The JAX package shards a tile along H over a mesh axis and lets GSPMD
partition ``g_apply``: a halo exchange around every convolution and
reflect pad, an all-reduce of every instance norm's statistics (and of the
int8 trunk's moment sums).  Here each process holds one contiguous range of
the rows of the network input (the tile after ``g_apply``'s reflect pad)
and those collectives are written out in the generator's serving forward
(``ResnetGenerator.forward_rows``):

  * ``Shard.rows``: the slab of a layer, this shard's rows with ``top``
    rows above and ``bottom`` below, the neighbours' edge rows from one
    ``all_gather`` of every shard's edge rows in the spatial group, the
    border's rows (reflect, replicate, zero) at the tile's global top and
    bottom; ``assemble`` is the pure part, a function of (own rows,
    neighbour rows, is-first, is-last);
  * ``Shard.norm``: the instance norm split in two: each shard's sums
    (``instance_norm_sums``, (B, 4, C)), gathered, then the elementwise
    pass over this shard with the sums of all shards added in shard order
    and the tile's pixel count (``instance_norm_apply``), so the statistics
    do not depend on a collective's reduction order and every shard
    normalises with the same numbers;
  * ``Shard.add``: the int8 trunk's moments (kernel D's exact f64 sums,
    (B, 2, C)) summed over the shards in shard order, so they equal the
    whole tile's and kernel E rounds them as it would those (a shard's int8
    values are the one process's); kernel E takes the tile's pixel count.

For the ResNet every boundary between two shards lies on a multiple of 4
network-input rows (``row_ranges``), so both stride-2 stages start every
shard on an even row: a k3 s2 p1 conv then needs one row above a shard and
none below, and the k3 s2 transposed convs one row below and none above.

A U-Net (``UnetGenerator.forward_rows``) halves the tile ``num_downs``
times.  Its level-l map has H / 2^l rows, and its k4 s2 p1 conv from level
l needs every boundary on an even row of level l; so the boundaries lie on
multiples of 2^k network-input rows, k the deepest level (at most
``num_downs``) at which each shard still holds a row (``unet_depth``):
128^2 over 4 shards gives k = 5, 512^2 over 4 with unet_256 k = 7, 2048^2
over 2 k = 8 = ``num_downs``.  Down to level k every layer runs on the
shard's slab: the k4 s2 p1 conv and transposed conv each need one row above
and one below (``Shard.down4_slab``, ``Shard.up4_slab``).  The level-k map
is gathered whole to every shard (``Shard.whole``), the blocks under it
run there alike, and each shard carries on up with its own rows.

``predict_large_tile`` serves one tile H-sharded over the processes of the
group (one process per card: ``torchrun --nproc-per-node N``; on the CPU
processes over gloo), ``predict_tiles_2d`` a batch over a ``Grid`` of
(n_data, n_spatial) processes, B over the data axis and H over the spatial
axis.  Both return the whole prediction on every process.  A world without
a process group is one shard: the slabs and the split norm still run, with
no collective.  Every generator of the factory is covered: the resnets
(every ``padding_type``, the float and the int8 trunk and stage 2) and the
U-Nets (unpadded tiles, ``Data.padding: false``), each with the instance
norm, the batch norm in eval mode or no norm.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from nirgan_tpu_torch.ops.instance_norm import instance_norm_apply, instance_norm_sums
from nirgan_tpu_torch.ops.pad import reflect_pad2d
from nirgan_tpu_torch.parallel.mesh import Mesh, all_gather_rows

__all__ = ["Grid", "Shard", "assemble", "create_grid", "edge_rows", "pad_cols",
           "predict_large_tile", "predict_tiles_2d", "row_ranges", "shard_ranges",
           "spatial_predict_fn", "spatial_predict_fn_2d", "unet_depth"]

BORDERS = ("reflect", "replicate", "zero")
# the fewest network-input rows a shard may hold: the trunk's reflect border
# at a global edge reads a second row of the shard at 1/4 of the resolution
MIN_ROWS = 8


# ------------------------------------------------------------ row ranges
def row_ranges(n_rows: int, n: int, unit: int = 4,
               min_rows: int = MIN_ROWS) -> list[tuple[int, int]]:
    """The rows [lo, hi) of each of n shards of ``n_rows`` network-input
    rows: every boundary on a multiple of ``unit`` (the ResNet's two
    halvings: 4), the ranges as equal as that allows, the larger ones first
    (2068 rows over 2: 1036 and 1032).  Raises ValueError where a shard
    would hold fewer than ``min_rows``."""
    units = n_rows // unit
    cuts = [0] + [unit * (-(-k * units // n)) for k in range(1, n)] + [n_rows]
    ranges = list(zip(cuts[:-1], cuts[1:]))
    if min(hi - lo for lo, hi in ranges) < min_rows:
        raise ValueError(f"{n} shards of {n_rows} rows leave a shard fewer than "
                         f"{min_rows} rows")
    return ranges


def unet_depth(n_rows: int, n: int, num_downs: int) -> int:
    """The deepest level k <= ``num_downs`` to which a U-Net's tile of
    ``n_rows`` rows stays sharded over n shards: the level-k map, of
    n_rows / 2^k rows, still gives each shard at least one.  Raises
    ValueError where no level does (fewer rows than shards)."""
    for k in range(num_downs, -1, -1):
        if n_rows % (1 << k) == 0 and n_rows >> k >= n:
            return k
    raise ValueError(f"{n} shards of {n_rows} rows leave a shard no row")


def shard_ranges(task, n_rows: int, n: int) -> list[tuple[int, int]]:
    """``row_ranges`` for the task's generator: the ResNet's unit of 4 rows
    and ``MIN_ROWS``; for a U-Net a unit of 2^k rows (``unet_depth``) and
    one unit at least, a row at level k."""
    downs = getattr(task.netG, "num_downs", None)
    if downs is None:
        return row_ranges(n_rows, n)
    unit = 1 << unet_depth(n_rows, n, downs)
    return row_ranges(n_rows, n, unit, unit)


# ---------------------------------------------------------------- borders
def _check_border(border: str) -> None:
    if border not in BORDERS:
        raise ValueError(f"border must be one of {BORDERS}, got {border!r}")


def edge_rows(x: torch.Tensor, r: int, border: str, top: bool, dim: int = 1) -> torch.Tensor:
    """The ``r`` rows (along ``dim``) that ``border`` puts above (``top``)
    or below the rows of x: ``ReflectionPad2d``'s mirror without the edge
    row, ``ReplicationPad2d``'s copies of the edge row, or zeros."""
    _check_border(border)
    n = x.shape[dim]
    if border == "reflect":
        picked = x.narrow(dim, 1, r) if top else x.narrow(dim, n - 1 - r, r)
        return picked.flip(dim)
    if border == "replicate":
        edge = x.narrow(dim, 0 if top else n - 1, 1)
        return edge.expand(*[r if d == dim else -1 for d in range(x.dim())])
    shape = list(x.shape)
    shape[dim] = r
    return x.new_zeros(shape)


def pad_cols(x: torch.Tensor, r: int, border: str) -> torch.Tensor:
    """NHWC x with ``r`` columns of ``border`` on both sides (the whole
    width lies on every shard)."""
    if r == 0:
        return x
    return torch.cat([edge_rows(x, r, border, True, 2), x,
                      edge_rows(x, r, border, False, 2)], 2).contiguous()


def assemble(x: torch.Tensor, above: Optional[torch.Tensor],
             below: Optional[torch.Tensor], top: int, bottom: int, border: str,
             first: bool, last: bool) -> torch.Tensor:
    """The slab (B, top + h + bottom, W, C) of this shard's rows x: above
    them the previous shard's last ``top`` rows (``above``), or at the
    tile's top (``first``) the border's; below them the next shard's first
    ``bottom`` rows (``below``), or at the tile's bottom (``last``) the
    border's.  A pure function: a whole map's pad is its case of one shard,
    first and last."""
    parts = []
    if top:
        parts.append(edge_rows(x, top, border, True) if first else above)
    parts.append(x)
    if bottom:
        parts.append(edge_rows(x, bottom, border, False) if last else below)
    return torch.cat(parts, 1).contiguous() if len(parts) > 1 else x


# ------------------------------------------------------------------ shard
class Shard:
    """This process's rows [lo, hi) of a tile of ``total_rows`` network-input
    rows, shard ``index`` of ``len(ranges)`` in the spatial ``group`` (None:
    the default group).  ``distributed`` False is a world of one: no
    collective runs; under a process group they run, even for one shard."""

    def __init__(self, ranges: list, index: int, group=None,
                 distributed: bool = False):
        self.ranges, self.index = list(ranges), int(index)
        self.n = len(self.ranges)
        self.group = group
        self.distributed = bool(distributed)
        self.lo, self.hi = self.ranges[self.index]
        self.total_rows = self.ranges[-1][1]
        self.first, self.last = self.index == 0, self.index == self.n - 1

    def gather(self, t: torch.Tensor) -> list:
        """Every shard's t (of one shape), in shard order."""
        if not self.distributed:
            return [t]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.n)]
        dist.all_gather(parts, t, group=self.group)
        return parts

    def rows(self, x: torch.Tensor, top: int, bottom: int, border: str) -> torch.Tensor:
        """The slab of NHWC x: ``top`` rows above, ``bottom`` below, from
        the neighbours (one collective) or, at the tile's edges, the
        border's (``assemble``)."""
        above = below = None
        if self.distributed and (top or bottom):
            h = x.shape[1]
            parts = self.gather(torch.cat([x[:, :bottom], x[:, h - top:]], 1))
            above = None if self.first else parts[self.index - 1][:, bottom:]
            below = None if self.last else parts[self.index + 1][:, :bottom]
        return assemble(x, above, below, top, bottom, border, self.first, self.last)

    def slab(self, x: torch.Tensor, top: int, bottom: int, border: str,
             cols: int) -> torch.Tensor:
        """``rows``, then ``cols`` columns of the border on both sides."""
        return pad_cols(self.rows(x, top, bottom, border), cols, border)

    def down_slab(self, x: torch.Tensor) -> torch.Tensor:
        """The slab of a k3 s2 p1 conv (zero border): one row above and a
        column on both sides; below, a zero row where the shard's rows are
        odd, which only the last shard's can be.  Its VALID stride-2 conv
        gives this shard's rows of the whole map's conv."""
        h = x.shape[1]
        if h % 2 and not self.last:
            raise ValueError(f"shard {self.index} has an odd {h} rows")
        s = self.rows(x, 1, 0, "zero")
        if h % 2:
            s = torch.cat([s, s.new_zeros((s.shape[0], 1) + tuple(s.shape[2:]))], 1)
        return pad_cols(s, 1, "zero")

    def up_slab(self, x: torch.Tensor) -> torch.Tensor:
        """The slab of a k3 s2 p1 op1 transposed conv: one row below (the
        next shard's first, zero at the tile's bottom).  Output row o reads
        input rows (o + 1 - k) / 2, k in 0..2: the shard's last output row
        2h - 1 reads row h, no output row reads above row 0, so the first
        2h rows of the slab's conv are this shard's."""
        return self.rows(x, 0, 1, "zero")

    def down4_slab(self, x: torch.Tensor) -> torch.Tensor:
        """The slab of a k4 s2 p1 conv (zero border): one row above, one
        below and a column on both sides.  Output row o reads input rows
        2o - 1 ... 2o + 2, so a shard of an even count of rows [lo, hi),
        lo even, reads rows lo - 1 ... hi: the VALID stride-2 conv of the
        slab gives the rows [lo / 2, hi / 2) of the whole map's conv."""
        if x.shape[1] % 2:
            raise ValueError(f"shard {self.index} has an odd {x.shape[1]} rows")
        return pad_cols(self.rows(x, 1, 1, "zero"), 1, "zero")

    def up4_slab(self, x: torch.Tensor) -> torch.Tensor:
        """The slab of a k4 s2 p1 transposed conv: one row above and one
        below (zero at the tile's edges).  Output row o reads input rows
        (o + 1 - k) / 2, k in 0..3, so this shard's output rows [2 lo,
        2 hi) read rows lo - 1 ... hi, all in the slab.  Slab row s is row
        lo - 1 + s, and the slab's transposed conv with its padding of 1
        puts 2 s - 1 + k = o - 2 lo + 2: of its 2 h + 4 rows, rows
        [2, 2 h + 2) are this shard's; the two at each end belong to the
        neighbours (at the tile's edges they read the zero rows and no
        whole-map row)."""
        return self.rows(x, 1, 1, "zero")

    def whole(self, x: torch.Tensor, level: int) -> torch.Tensor:
        """The whole map of which x holds this shard's rows at ``level``
        (the shard's network-input rows / 2^level): every shard's rows in
        shard order, from one ``all_gather`` of the rows padded to the
        longest shard's and cut back."""
        counts = [(hi - lo) >> level for lo, hi in self.ranges]
        short = max(counts) - x.shape[1]
        if short:
            x = torch.cat([x, x.new_zeros((x.shape[0], short) + tuple(x.shape[2:]))], 1)
        return torch.cat([p[:, :c] for p, c in zip(self.gather(x), counts)], 1)

    def add(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every shard's t in shard order (the same on every
        shard)."""
        parts = self.gather(t)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def norm(self, x: torch.Tensor, count: int, relu: bool = False,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The affine-free instance norm of the tile at this shard's rows:
        the shards' sums gathered, the tile's ``count`` pixels."""
        parts = torch.stack(self.gather(instance_norm_sums(x)), 1)
        return instance_norm_apply(x, parts, count, 1e-5, relu, residual)


# ------------------------------------------------------------------- grid
@dataclass(frozen=True)
class Grid:
    """A 2-D grid of (n_data, n_spatial) processes over ``mesh``: rank r at
    (r // n_spatial, r % n_spatial), with the process groups of its spatial
    row and its data column (None without a process group)."""

    mesh: Mesh
    n_data: int
    n_spatial: int
    spatial_group: object = None
    data_group: object = None

    @property
    def data_index(self) -> int:
        return self.mesh.rank // self.n_spatial

    @property
    def spatial_index(self) -> int:
        return self.mesh.rank % self.n_spatial


def create_grid(mesh: Mesh, n_data: int, n_spatial: int) -> Grid:
    """The (n_data, n_spatial) grid of ``mesh``'s processes.  Every process
    creates every spatial row's group, then every data column's, in that
    order (``dist.new_group`` is collective)."""
    if n_data * n_spatial != mesh.world_size:
        raise ValueError(f"a ({n_data}, {n_spatial}) grid needs {n_data * n_spatial} "
                         f"processes, the world has {mesh.world_size}")
    if not mesh.distributed:
        return Grid(mesh, n_data, n_spatial)
    rows = [dist.new_group([i * n_spatial + j for j in range(n_spatial)])
            for i in range(n_data)]
    cols = [dist.new_group([i * n_spatial + j for i in range(n_data)])
            for j in range(n_spatial)]
    return Grid(mesh, n_data, n_spatial, rows[mesh.rank // n_spatial],
                cols[mesh.rank % n_spatial])


# ---------------------------------------------------------------- serving
def _predict_fn(task, index: int, n: int, group, distributed: bool) -> Callable:
    """The callable of shard ``index`` of n in ``group``: the counterpart of
    the jitted function of ``spatial_predict_fn``."""
    p = task.pad_amount
    unet = getattr(task.netG, "num_downs", None) is not None

    @torch.inference_mode()
    def fn(x_rows: torch.Tensor, tile_rows: int, trunk_q: Optional[dict] = None):
        """x_rows (B, h, W + 2 p, C): this shard's rows [lo, hi) of the
        network input (the tile of ``tile_rows`` rows after ``g_apply``'s
        reflect pad p), on this process's device -> this shard's rows of
        the (B, H', W, 1) f32 prediction after ``g_apply``'s crop."""
        task.netG.train(False)
        shard = Shard(shard_ranges(task, tile_rows + 2 * p, n), index, group, distributed)
        if x_rows.shape[1] != shard.hi - shard.lo:
            raise ValueError(f"shard {index} holds rows [{shard.lo}, {shard.hi}), "
                             f"got {x_rows.shape[1]}")
        pred = task.netG.forward_rows(x_rows.to(task.compute_dtype), shard, trunk_q)
        if unet:
            # a U-Net's output rows are its input rows: the shard's [lo, hi)
            out_rows = shard.total_rows
        else:
            # the network's output rows of this shard start at its first
            # input row (two halvings, rounded up, then two doublings)
            out_rows = 4 * (((shard.total_rows + 1) // 2 + 1) // 2)
        # g_apply's crop keeps [p, out - p)
        lo = max(p - shard.lo, 0)
        hi = min(out_rows - p, shard.lo + pred.shape[1]) - shard.lo
        w = pred.shape[2]
        return pred[:, lo:max(hi, lo), p:w - p].float()

    return fn


def spatial_predict_fn(task, mesh: Mesh) -> Callable:
    """This process's part of the H-sharded serving forward over ``mesh``'s
    processes (one shard each, in rank order): ``fn(x_rows, tile_rows,
    trunk_q=None)`` (see ``_predict_fn``)."""
    return _predict_fn(task, mesh.rank, mesh.world_size, None, mesh.distributed)


def spatial_predict_fn_2d(task, grid: Grid) -> Callable:
    """This process's part over a ``Grid``: its data row's samples, its
    spatial index's rows, the collectives in its spatial row's group; the
    callable of ``spatial_predict_fn``."""
    return _predict_fn(task, grid.spatial_index, grid.n_spatial, grid.spatial_group,
                       grid.mesh.distributed)


def _network_input(task, rgb: np.ndarray, batch: slice) -> torch.Tensor:
    """The network input of ``g_apply`` for the samples ``batch`` of the
    NCHW tile: NHWC, reflect-padded by the task's pad."""
    x = torch.from_numpy(np.ascontiguousarray(rgb[batch].transpose(0, 2, 3, 1)))
    return reflect_pad2d(x, task.pad_amount) if task.use_padding else x


def _check_sides(task, rgb: np.ndarray) -> None:
    """A U-Net's side check (``check_unet_side``) on both sides of the NCHW
    tile, before any collective."""
    for side in rgb.shape[2:]:
        task.check_unet_side(side)


def _gather_rows(pred: torch.Tensor, mesh: Mesh, group) -> torch.Tensor:
    """(B, h, W, 1) rows of every shard of ``group`` -> (B, H, W, 1)."""
    if not mesh.distributed:
        return pred
    parts = all_gather_rows(pred.transpose(0, 1).contiguous(), mesh, group)
    return torch.cat(parts, 0).transpose(0, 1)


def predict_tiles_2d(task, rgb_nchw, grid: Grid, trunk_q: Optional[dict] = None) -> np.ndarray:
    """Serve a (B, 3, H, W) batch sharded B x H over ``grid``: B must divide
    by the grid's data size and H by 4 x its spatial size (and, for a
    U-Net, H and W by 2^num_downs).  Returns the (B, 1, H, W) f32
    prediction on every process."""
    nb, nh = grid.n_data, grid.n_spatial
    rgb = np.asarray(rgb_nchw, np.float32)
    b, _, h, _ = rgb.shape
    if b % nb != 0:
        raise ValueError(f"B={b} must be a multiple of the grid's data size {nb}")
    if h % (4 * nh) != 0:
        raise ValueError(f"H={h} must be a multiple of {4 * nh} "
                         f"(4 × the grid's spatial size {nh})")
    _check_sides(task, rgb)
    fn = spatial_predict_fn_2d(task, grid)
    per = b // nb
    x = _network_input(task, rgb, slice(grid.data_index * per, (grid.data_index + 1) * per))
    lo, hi = shard_ranges(task, x.shape[1], nh)[grid.spatial_index]
    pred = fn(x[:, lo:hi].to(grid.mesh.device), h, trunk_q)
    pred = _gather_rows(pred, grid.mesh, grid.spatial_group)
    if grid.mesh.distributed:
        pred = torch.cat(all_gather_rows(pred, grid.mesh, grid.data_group), 0)
    return pred.permute(0, 3, 1, 2).cpu().numpy()


def predict_large_tile(task, rgb_nchw, mesh: Mesh, trunk_q: Optional[dict] = None) -> np.ndarray:
    """Serve a (1, 3, H, W) tile H-sharded over ``mesh``'s processes; H must
    be a multiple of 4 x the number of processes (and, for a U-Net, H and
    W of 2^num_downs).  Returns the (1, 1, H, W) f32 prediction on every
    process."""
    n = mesh.world_size
    rgb = np.asarray(rgb_nchw, np.float32)
    _, _, h, _ = rgb.shape
    if h % (4 * n) != 0:
        raise ValueError(f"H={h} must be a multiple of {4 * n} "
                         f"(4 × the {n} processes) for spatial sharding")
    _check_sides(task, rgb)
    fn = spatial_predict_fn(task, mesh)
    x = _network_input(task, rgb, slice(None))
    lo, hi = shard_ranges(task, x.shape[1], n)[mesh.rank]
    pred = _gather_rows(fn(x[:, lo:hi].to(mesh.device), h, trunk_q), mesh, None)
    return pred.permute(0, 3, 1, 2).cpu().numpy()
