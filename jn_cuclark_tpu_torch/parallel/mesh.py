"""Classification over several devices of one process.

The port of the JAX package's parallel/mesh.py.  A `Mesh` is an explicit
list of torch devices with its axis names; the list may name one device
more than once, which runs every piece of the sharded semantics on one card
(the JAX package checks its meshes on virtual CPU devices the same way).
Three modes, as in the JAX package:

  db        ShardedRadixTable: the table's rows in equal contiguous ranges,
            one per db shard, each range optionally streamed in cycles;
            every shard runs K1 and the chunk probe K7 over the batch
  dp        shard_reads: the table on every device, the batch's rows in
            equal blocks, each classified by K1, K2 and K3/K4/K5
  dp x db   shard_reads_db: both at once on a two-axis mesh

A key lives in exactly one row and the stash counts only on db shard 0 (at
cycle 0), so the db shards' per-window labels are disjoint and `_reduce`
sums them onto one device: the JAX package's psum, and the one place a
multi-process run adds its all-reduce.  Scoring then runs as on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import device_pipeline, radix_table, score
from ..utils import memory


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


def _distinct(devices) -> list:
    """The devices in first-seen order, each once."""
    return list(dict.fromkeys(devices))


def _placements(grid) -> list:
    """The (device, db shard) pairs of a [dp][db] grid, each once: the dp
    blocks on one device share a db shard's rows there."""
    return _distinct((d, j) for row in grid for j, d in enumerate(row))


class Mesh:
    """Devices on one axis (("db",) or ("dp",)) or two (("dp", "db")).

    `devices` is a list for one axis and a list of equal rows for two: row
    i holds the db shards of dp block i.  A device may appear more than
    once.  `grid` is always the list of rows (one row on a one-axis mesh)."""

    def __init__(self, devices, axis_names):
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) == 1:
            rows = [list(devices)]
        elif len(self.axis_names) == 2:
            rows = [list(r) for r in devices]
        else:
            raise ValueError(f"a mesh has one or two axes, got {axis_names}")
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh needs devices, in rows of one length")
        self.grid = [[_device(d) for d in r] for r in rows]
        self.shape = ((len(rows[0]),) if len(self.axis_names) == 1
                      else (len(rows), len(rows[0])))
        self.devices = [d for r in self.grid for d in r]

    @property
    def size(self) -> int:
        return len(self.devices)


def _devices(n: int | None, device, what: str) -> list:
    kind = torch.device(device).type
    if kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n is None else n
        if not 1 <= n <= have:
            # the mesh neither shrinks nor moves to the CPU
            raise ValueError(f"{what} needs {n} CUDA devices, this machine "
                             f"has {have}")
        return [torch.device("cuda", i) for i in range(n)]
    if kind == "cpu":
        n = 1 if n is None else n
        if n < 1:
            raise ValueError(f"{what} needs at least one device, got {n}")
        return [torch.device("cpu")] * n
    raise ValueError(f"unsupported device {device!r} (cuda or cpu)")


def make_mesh(n_devices: int | None = None, axis: str = "db",
              device="cuda") -> Mesh:
    """One-axis mesh over the first n_devices CUDA devices (all of them by
    default); raises where the machine has fewer.  device="cpu" gives
    n_devices CPU shards (one by default)."""
    return Mesh(_devices(n_devices, device, f"a mesh of {n_devices}"),
                (axis,))


def make_mesh2d(dp: int, db: int, device="cuda") -> Mesh:
    """[dp, db] mesh over the first dp*db devices, column-major as in the
    JAX package: column j holds dp consecutive devices."""
    devs = _devices(dp * db, device, f"mesh {dp}x{db}")
    return Mesh([[devs[j * dp + i] for j in range(db)] for i in range(dp)],
                ("dp", "db"))


def _reduce(parts, device) -> torch.Tensor:
    """The db shards' per-window labels (int32 label+1, 0 = miss) summed
    on `device`.  They are disjoint, so the sum is each window's label; it
    is taken in int32, before any narrowing to u16."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _split_rows(x: torch.Tensor, n: int):
    """x's rows zero-padded to a multiple of n, as n equal blocks."""
    r = (-x.shape[0]) % n
    if r:
        x = torch.cat([x, x.new_zeros((r,) + tuple(x.shape[1:]))])
    return torch.tensor_split(x, n)


def _gather(outs, device):
    """Each output of the blocks, concatenated in block order on device."""
    return tuple(torch.cat([o[i].to(device) for o in outs])
                 for i in range(len(outs[0])))


def _run_blocks(grid, words, vwords, k: int, probe_cols, probe, finish):
    """One batch over a [dp][db] grid of devices: the rows split into one
    block per grid row; in each, K1 once on every distinct device of the
    row, probe(j, device, q) for each db shard j, the labels summed onto
    the row's first device and the invalid windows zeroed, then
    finish(labels [R_i, W]) -> a tuple of outputs.  The outputs come back
    in read order on the grid's first device."""
    with torch.inference_mode():
        outs = []
        for row, w, v in zip(grid, _split_rows(words, len(grid)),
                             _split_rows(vwords, len(grid))):
            q = {d: device_pipeline.window_canonicals(w.to(d), v.to(d), k,
                                                      probe_cols)
                 for d in _distinct(row)}
            lab = _reduce([probe(j, d, q[d].view(-1))
                           for j, d in enumerate(row)], row[0])
            outs.append(finish(device_pipeline._masked(q[row[0]], lab)))
        return _gather(outs, grid[0][0])


class ShardedRadixTable:
    """The radix table sharded by rows over the db axis of a mesh, with
    out-of-core cycling inside each shard.

    The plan (row count, label packing, stash) comes once from the raw
    keys; db shard j holds rows [j*rpd, (j+1)*rpd), rpd rounded up to a
    multiple of the cycles, and streams them in chunks of rpc = rpd/cycles
    rows, cycle c's from row j*rpd + c*rpc.  Rows past the table are EMPTY,
    so a shard wholly or partly past it probes them as misses.  On a
    two-axis mesh the batch's rows also split over dp, each dp block
    probing every db shard of its row of the mesh."""

    def __init__(self, mesh: Mesh, keys, labels1, n_targets: int, k: int,
                 db_cycles: int | str = 1, transient: int = 0):
        self.mesh = mesh
        self.ndp, self.ndb = len(mesh.grid), len(mesh.grid[0])
        self.n_targets, self.k = n_targets, k
        keys = np.asarray(keys, dtype=np.uint64)
        labels1 = np.asarray(labels1, dtype=np.int32)
        plan = radix_table.plan_table(keys, labels1, k=k)
        self.meta = plan.meta
        self.m1, self.lb, self.c = plan.m1, plan.lb, plan.c
        if db_cycles in ("auto", 0, None):
            db_cycles, _ = memory.auto_db_cycles(
                plan.n_rows * plan.c * 8, transient, device=mesh.devices[0],
                n_shards=self.ndb)
        self.n_cycles = db_cycles = int(db_cycles)
        if db_cycles < 1:
            raise ValueError(f"db_cycles must be positive, got {db_cycles}")
        rpd = -(-plan.n_rows // self.ndb)
        self.rpd = rpd = -(-rpd // db_cycles) * db_cycles
        self.rpc = rpd // db_cycles
        # host chunks [cycle][db shard]
        self._host = [
            [radix_table.fill_rows(keys, labels1, plan, r0, r0 + self.rpc)[0]
             for r0 in (j * rpd + cyc * self.rpc for j in range(self.ndb))]
            for cyc in range(db_cycles)
        ]
        self._placements = _placements(mesh.grid)
        self._stash = {d: radix_table.put_stash(plan.stash_keys,
                                                plan.stash_labels, d)
                       for d in _distinct(mesh.devices)}
        self._resident = None
        if db_cycles == 1:
            self._resident = {
                (d, j): torch.from_numpy(self._host[0][j].view(np.int32)).to(d)
                for d, j in self._placements}
            self._host = None

    @property
    def shard_bytes(self) -> int:
        """Device bytes of one shard's chunk."""
        return self.rpc * self.c * 8

    def _probe(self, chunks, cycle: int):
        def probe(j, d, q):
            return radix_table.probe_chunk(
                chunks[d, j], *self._stash[d], q,
                j * self.rpd + cycle * self.rpc, m1=self.m1, lb=self.lb,
                use_stash=j == 0 and cycle == 0)

        return probe

    def classify(self, words, vwords, extended=False, probe_cols=None):
        """Resident batch step: (total, ibest, best, sbest, extra) as
        device_pipeline.classify_batch gives them (extended False: K3,
        "sorted": K4, True: K5), rows padded to a multiple of the dp
        width."""
        if self._resident is None:
            raise RuntimeError("the table is cycled: batches run through "
                               "upload_cycle and cycle_step")
        return _run_blocks(
            self.mesh.grid, words, vwords, self.k, probe_cols,
            self._probe(self._resident, 0),
            lambda lab: device_pipeline.score_from_labels(
                lab, n_targets=self.n_targets, extended=extended))

    def upload_cycle(self, cycle: int, put) -> dict:
        """{(device, db shard): put(host chunk, device)} for one cycle;
        put(host array, device) -> (tensor, its copy's event or None)."""
        return {(d, j): put(self._host[cycle][j], d)
                for d, j in self._placements}

    def cycle_step(self, chunks: dict, cycle: int, kind: str, words, vwords,
                   probe_cols=None) -> torch.Tensor:
        """One batch against one cycle's chunks ({(device, db shard):
        slots}): kind "counts" -> per-read counts [R, T+1] int32 (K5's;
        column 0 the cycle's misses), "labels" -> the per-window labels
        [R, W], u16 on an int16 carrier below 65,535 targets."""
        if kind == "labels":
            narrow = self.n_targets < 65535

            def finish(lab):
                return (score.u16_bits(lab) if narrow else lab,)
        else:
            def finish(lab):
                return (score.counts_top2(lab, self.n_targets)[0],)
        return _run_blocks(self.mesh.grid, words, vwords, self.k,
                           probe_cols, self._probe(chunks, cycle), finish)[0]


def shard_reads(mesh: Mesh, table: radix_table.RadixTable, n_targets: int,
                k: int):
    """Data-parallel mode: the table on every distinct device of the mesh,
    the batch's rows zero-padded to a multiple of the mesh size and split
    into equal blocks, block i classified on device i (K1, K2, then K3, K4
    or K5).  Returns ({device: DeviceTable}, batch_fn); batch_fn's outputs
    are in read order on the first device, pad rows included."""
    devs = mesh.devices
    tables = {d: radix_table.to_device(table, d) for d in _distinct(devs)}

    def batch_fn(words, vwords, extended=False, probe_cols=None):
        with torch.inference_mode():
            outs = [
                device_pipeline.classify_batch(
                    tables[d], w.to(d), v.to(d), k=k, n_targets=n_targets,
                    extended=extended, probe_cols=probe_cols)
                for d, w, v in zip(devs, _split_rows(words, len(devs)),
                                   _split_rows(vwords, len(devs)))
            ]
            return _gather(outs, devs[0])

    return tables, batch_fn


def shard_reads_db(mesh: Mesh, table: radix_table.RadixTable, n_targets: int,
                   k: int):
    """Two-axis composition: the table's rows over the db axis (padded
    with EMPTY rows to db x rpd) and the batch's rows over dp.  Each dp
    block probes every db shard of its mesh row (K1, K7; the stash on db
    shard 0), the labels are summed over db only, then scored by K3, K4 or
    K5.  Returns ({(device, db shard): slots}, batch_fn)."""
    if len(mesh.axis_names) != 2:
        raise ValueError("shard_reads_db needs a (dp, db) mesh")
    ndb = mesh.shape[1]
    c = table.slot_width
    rows = table.slots.shape[0]
    rpd = -(-rows // ndb)
    slots = table.slots
    if ndb * rpd != rows:
        slots = np.concatenate([slots, np.full(
            (ndb * rpd - rows, 2 * c), radix_table.EMPTY32, np.uint32)])
    shards = {
        (d, j): torch.from_numpy(
            slots[j * rpd : (j + 1) * rpd].view(np.int32)).to(d)
        for d, j in _placements(mesh.grid)
    }
    stash = {d: radix_table.put_stash(table.stash_keys, table.stash_labels, d)
             for d in _distinct(mesh.devices)}

    def probe(j, d, q):
        return radix_table.probe_chunk(shards[d, j], *stash[d], q, j * rpd,
                                       m1=table.m1, lb=table.lb,
                                       use_stash=j == 0)

    def batch_fn(words, vwords, extended=False, probe_cols=None):
        return _run_blocks(
            mesh.grid, words, vwords, k, probe_cols, probe,
            lambda lab: device_pipeline.score_from_labels(
                lab, n_targets=n_targets, extended=extended))

    return shards, batch_fn
