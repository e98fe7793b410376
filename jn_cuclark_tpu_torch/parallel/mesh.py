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
sums them onto one device: the JAX package's psum.  Scoring then runs as on
one device.

Across processes (parallel/dist.py initialized), make_mesh and make_mesh2d
with across_processes=True give a mesh of every process's devices, each
process's contiguous, as the JAX package's sort by (process_index, id) does;
each entry names the process that owns it.  A process fills and probes only the db shards it owns (1/P
of the table in its host memory), and the batch's labels, summed over its
own shards, are summed over the world by one all_reduce (`_all_reduce`)
before the miss mask and the scoring, which every process runs on the
whole batch.  Every process packs the same batches, so the all-reduces pair
up in order.  The db mode and the flat path cross processes.

The flat path's sorted index (`shard_index`, packed=False) splits its keys
in equal blocks over the mesh's first axis, as the JAX package's shard_map
does (a two-axis mesh's second axis repeats the blocks, so its first
column holds them), each with its own radix directory: each block runs the
search K9 over the batch's queries, the blocks' labels are summed by
`_reduce` (a key lies in one block), and K5's flat form scores on the
first device.  On a process mesh a process holds only its own blocks, and
the batch's labels, summed over them, are summed over the world by one
all_reduce before the scoring, which every process runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import device_pipeline, lookup, radix_table, score
from ..utils import memory
from ..utils.profiling import maybe_phase
from . import dist


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


def _distinct(devices) -> list:
    """The devices in first-seen order, each once."""
    return list(dict.fromkeys(devices))


def _placements(mesh) -> list:
    """The (device, db shard) pairs of this process's entries of the
    mesh, each once: the dp blocks on one device share a db shard's rows
    there."""
    return _distinct((d, j) for i, row in enumerate(mesh.grid)
                     for j, d in enumerate(row) if (i, j) in mesh.local)


class Mesh:
    """Devices on one axis (("db",) or ("dp",)) or two (("dp", "db")).

    `devices` is a list for one axis and a list of equal rows for two: row
    i holds the db shards of dp block i.  A device may appear more than
    once.  `grid` is always the list of rows (one row on a one-axis mesh).

    `owners`, in the shape of `devices`, gives the process of each entry
    and makes a process mesh, whose batches end in an all-reduce over the
    world (a world of one included); this process's entries are `local`,
    the others' devices only placeholders.  Without it every entry is this
    process's and nothing is reduced across processes."""

    def __init__(self, devices, axis_names, owners=None):
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) == 1:
            rows = [list(devices)]
            owner_rows = None if owners is None else [list(owners)]
        elif len(self.axis_names) == 2:
            rows = [list(r) for r in devices]
            owner_rows = None if owners is None else [list(r) for r in owners]
        else:
            raise ValueError(f"a mesh has one or two axes, got {axis_names}")
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh needs devices, in rows of one length")
        self.grid = [[_device(d) for d in r] for r in rows]
        self.shape = ((len(rows[0]),) if len(self.axis_names) == 1
                      else (len(rows), len(rows[0])))
        self.devices = [d for r in self.grid for d in r]
        self.collective = owner_rows is not None
        if self.collective:
            if [len(r) for r in owner_rows] != [len(r) for r in rows]:
                raise ValueError("a mesh's owners take its devices' shape")
            rank = dist.process_index()
        else:
            owner_rows, rank = [[0] * len(r) for r in rows], 0
        self.local = {(i, j) for i, r in enumerate(owner_rows)
                      for j, p in enumerate(r) if p == rank}
        if not self.local:
            raise ValueError("the mesh holds no device of this process")
        self.local_devices = _distinct(
            d for i, r in enumerate(self.grid) for j, d in enumerate(r)
            if (i, j) in self.local)

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


def process_devices(n_devices: int | None, device="cuda") -> list:
    """This process's share of n_devices devices of `device`'s kind:
    n_devices / P of them in a world of P processes (raises where P does
    not divide it), by default every CUDA card the process sees
    (CUDA_VISIBLE_DEVICES picks them) or one CPU shard.  Under torchrun
    (LOCAL_RANK set) a process drives its own card, cuda:LOCAL_RANK, alone,
    and a share of more than one card raises."""
    p = dist.process_count()
    if n_devices is not None and n_devices % p:
        raise ValueError(f"{n_devices} devices do not split over {p} "
                         "processes")
    n = None if n_devices is None else n_devices // p
    what = (f"{n_devices} devices over {p} processes" if p > 1
            else f"a mesh of {n_devices}")
    local_rank = dist.local_rank()
    if torch.device(device).type == "cuda" and local_rank is not None:
        if n not in (None, 1):
            raise ValueError(f"{what}: under torchrun (LOCAL_RANK) a "
                             "process drives one card")
        card = dist.local_device(device)
        _devices(card.index + 1, device, f"LOCAL_RANK={local_rank}")
        return [card]
    return _devices(n, device, what)


def _world_devices(n_devices: int | None, device):
    """(devices, owners) of every process's share, in process order."""
    if not dist.is_initialized():
        raise ValueError("a process mesh needs the world of "
                         "parallel/dist.initialize")
    local = process_devices(n_devices, device)
    p = dist.process_count()
    return local * p, [r for r in range(p) for _ in local]


def make_mesh(n_devices: int | None = None, axis: str = "db",
              device="cuda", across_processes: bool = False) -> Mesh:
    """One-axis mesh over the first n_devices CUDA devices (all of them by
    default); raises where the machine has fewer.  device="cpu" gives
    n_devices CPU shards (one by default).  across_processes=True gives a
    process mesh of every process's process_devices(n_devices) in the
    world that parallel/dist.initialize joined (a world of one included)."""
    if across_processes:
        devs, owners = _world_devices(n_devices, device)
        return Mesh(devs, (axis,), owners=owners)
    return Mesh(_devices(n_devices, device, f"a mesh of {n_devices}"),
                (axis,))


def make_mesh2d(dp: int, db: int, device="cuda",
                across_processes: bool = False) -> Mesh:
    """[dp, db] mesh over the first dp*db devices, column-major as in the
    JAX package: column j holds dp consecutive devices.  With
    across_processes=True the dp*db devices are every process's share, so
    with dp equal to a process's devices column j is process j's: db
    crosses processes and dp stays inside one."""
    if across_processes:
        devs, owners = _world_devices(dp * db, device)
    else:
        devs = _devices(dp * db, device, f"mesh {dp}x{db}")
        owners = None

    def grid(xs):
        return [[xs[j * dp + i] for j in range(db)] for i in range(dp)]

    return Mesh(grid(devs), ("dp", "db"),
                owners=None if owners is None else grid(owners))


def _reduce(parts, device, like=None) -> torch.Tensor:
    """The db shards' per-window labels (int32 label+1, 0 = miss) summed
    on `device`.  They are disjoint, so the sum is each window's label; it
    is taken in int32, before any narrowing to u16.  With no parts (a
    process owning none of a dp block's shards) the sum is zeros in the
    shape of `like`."""
    if not parts:
        return torch.zeros(like.numel(), dtype=torch.int32, device=device)
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _all_reduce(labs, device) -> list:
    """Each dp block's labels summed over the world's processes, by one
    all_reduce of the blocks side by side on `device`."""
    flat = torch.cat([x.to(device) for x in labs])
    with maybe_phase("all_reduce", flat.numel() * flat.element_size()):
        dist.all_reduce_sum_(flat)
    return [part.to(x.device) for part, x in
            zip(torch.split(flat, [x.numel() for x in labs]), labs)]


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


def _run_blocks(mesh: Mesh, words, vwords, k: int, probe_cols, probe,
                finish):
    """One batch over a mesh's [dp][db] grid: the rows split into one
    block per grid row; in each, K1 once on every distinct device of the
    row this process owns, probe(j, device, q) for each of its db shards
    j, the labels summed onto the row's first such device (this process's
    first device where it owns none of the row).  On a process mesh the
    blocks' sums are then summed over the world.  The invalid windows are
    zeroed and finish(labels [R_i, W]) gives a tuple of outputs, which
    come back in read order on this process's first device."""
    home = mesh.local_devices[0]
    with torch.inference_mode():
        qs, labs = [], []
        for i, (row, w, v) in enumerate(zip(
                mesh.grid, _split_rows(words, len(mesh.grid)),
                _split_rows(vwords, len(mesh.grid)))):
            mine = [(j, d) for j, d in enumerate(row) if (i, j) in mesh.local]
            at = mine[0][1] if mine else home
            q = {d: device_pipeline.window_canonicals(w.to(d), v.to(d), k,
                                                      probe_cols)
                 for d in _distinct([at] + [d for _, d in mine])}
            labs.append(_reduce([probe(j, d, q[d].view(-1))
                                 for j, d in mine], at, like=q[at]))
            qs.append(q[at])
        if mesh.collective:
            labs = _all_reduce(labs, home)
        outs = [finish(device_pipeline._masked(q, lab))
                for q, lab in zip(qs, labs)]
        return _gather(outs, home)


class ShardedRadixTable:
    """The radix table sharded by rows over the db axis of a mesh, with
    out-of-core cycling inside each shard.

    The plan (row count, label packing, stash) comes once from the raw
    keys; db shard j holds rows [j*rpd, (j+1)*rpd), rpd rounded up to a
    multiple of the cycles, and streams them in chunks of rpc = rpd/cycles
    rows, cycle c's from row j*rpd + c*rpc.  Rows past the table are EMPTY,
    so a shard wholly or partly past it probes them as misses.  On a
    two-axis mesh the batch's rows also split over dp, each dp block
    probing every db shard of its row of the mesh.  On a process mesh
    every process plans the whole table but fills only its own db shards'
    rows, and an "auto" cycle count is each process's, agreed as the
    largest over the world so that every process runs the same passes."""

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
                plan.n_rows * plan.c * 8, transient,
                device=mesh.local_devices[0], n_shards=self.ndb)
            if mesh.collective:
                db_cycles = dist.agree_max(db_cycles)
        self.n_cycles = db_cycles = int(db_cycles)
        if db_cycles < 1:
            raise ValueError(f"db_cycles must be positive, got {db_cycles}")
        rpd = -(-plan.n_rows // self.ndb)
        self.rpd = rpd = -(-rpd // db_cycles) * db_cycles
        self.rpc = rpd // db_cycles
        # host chunks [cycle]{db shard}, of this process's db shards only
        self._placements = _placements(mesh)
        self.local_db = sorted({j for _, j in self._placements})
        self._host = [
            {j: radix_table.fill_rows(keys, labels1, plan, r0,
                                      r0 + self.rpc)[0]
             for j, r0 in ((j, j * rpd + cyc * self.rpc)
                           for j in self.local_db)}
            for cyc in range(db_cycles)
        ]
        self._stash = {d: radix_table.put_stash(plan.stash_keys,
                                                plan.stash_labels, d)
                       for d in mesh.local_devices}
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

    @property
    def local_bytes(self) -> int:
        """Bytes of the table rows this process holds: its db shards'."""
        return len(self.local_db) * self.rpd * self.c * 8

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
            self.mesh, words, vwords, self.k, probe_cols,
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
        return _run_blocks(self.mesh, words, vwords, self.k,
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
        for d, j in _placements(mesh)
    }
    stash = {d: radix_table.put_stash(table.stash_keys, table.stash_labels, d)
             for d in _distinct(mesh.devices)}

    def probe(j, d, q):
        return radix_table.probe_chunk(shards[d, j], *stash[d], q, j * rpd,
                                       m1=table.m1, lb=table.lb,
                                       use_stash=j == 0)

    def batch_fn(words, vwords, extended=False, probe_cols=None):
        return _run_blocks(
            mesh, words, vwords, k, probe_cols, probe,
            lambda lab: device_pipeline.score_from_labels(
                lab, n_targets=n_targets, extended=extended))

    return shards, batch_fn


def _index_entries(mesh: Mesh) -> list:
    """The grid entries of the flat index's blocks, in block order: each
    entry of a one-axis mesh; the first column of a two-axis mesh, whose
    first axis holds the blocks and whose second only repeats them."""
    if len(mesh.axis_names) == 1:
        return [(0, j) for j in range(mesh.shape[0])]
    return [(i, 0) for i in range(mesh.shape[0])]


def shard_index(mesh: Mesh, keys: np.ndarray, labels1: np.ndarray,
                n_targets: int):
    """The flat path's sorted index over a mesh: keys (u64, ascending) and
    labels1 padded to a multiple of the mesh size (lookup.pad_index) and
    split into equal contiguous blocks over the mesh's first axis (its
    first column on a two-axis mesh), each a lookup.FlatIndex with its own
    radix directory on its entry's device (a block's range ends at its
    last key below the pad value, and a block of pad keys alone misses
    everything).  Only this process's blocks are built, each a copy of its
    own keys.  Returns (blocks, query_fn); query_fn(blocks, q, qread,
    n_reads) -> (total, ibest, best, sbest, counts) runs K9 on every block
    of this process, sums the labels on its first device (at most one
    block holds a query's key), on a process mesh sums them over the world
    by one all_reduce, and scores there with K5's flat form."""
    entries = _index_entries(mesh)
    keys, labels1 = lookup.pad_index(np.asarray(keys, dtype=np.uint64),
                                     np.asarray(labels1, dtype=np.int32),
                                     mesh.size)
    per = len(keys) // len(entries)
    blocks = [lookup.build_index(
        torch.from_numpy(keys[b * per : (b + 1) * per].view(np.int64)).to(
            mesh.grid[i][j], copy=True),
        torch.from_numpy(labels1[b * per : (b + 1) * per]).to(
            mesh.grid[i][j], copy=True))
        for b, (i, j) in enumerate(entries) if (i, j) in mesh.local]
    home = mesh.local_devices[0]

    def query_fn(blocks, q, qread, n_reads: int):
        with torch.inference_mode():
            lab = _reduce([lookup.lookup_labels(ix, q.to(ix.keys.device))
                           for ix in blocks], home, like=q)
            if mesh.collective:
                (lab,) = _all_reduce([lab], home)
            counts, total, ib, b, _, sb = score.counts_flat(
                lab, qread.to(home), n_reads, n_targets)
            return total, ib, b, sb, counts

    return blocks, query_fn
