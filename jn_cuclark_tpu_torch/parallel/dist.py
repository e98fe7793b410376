"""The processes of a multi-process run: torch.distributed, set up from the
cluster's variables, and the few collectives the port makes.

The port's counterpart of jax.distributed and jax.experimental.
multihost_utils.  `initialize` forms the world from explicit arguments, the
JAX package's variables (CLARK_TPU_NUM_PROCESSES, CLARK_TPU_PROCESS_ID,
CLARK_TPU_COORDINATOR, which `cluster --launch` presets) or torchrun's
(WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT; LOCAL_RANK picks the card).  The labels' all-reduce goes
through the world's backend: NCCL for CUDA devices, gloo for the CPU;
CLARK_TPU_DIST_BACKEND=gloo asks for gloo on CUDA tensors too, for a world
whose ranks share one card (NCCL refuses two ranks on one GPU).  A failed
backend raises: nothing moves to another one.  Host objects (the agreed
cycle count, the byte gather) go through a gloo group of their own, so
their order never mixes with the labels'.

Without `initialize` the process is a world of one: process_index() is 0,
process_count() 1, and agree_max and allgather_bytes return their input.
"""

from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 600  # a collective waits this long for its peers, then raises
BACKENDS = ("nccl", "gloo")

_host_group = None  # the gloo group of host objects, once initialized


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_from_env(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> tuple[str, int, int]:
    """(coordinator "host:port", world size, rank): the arguments where
    given, else CLARK_TPU_NUM_PROCESSES / CLARK_TPU_PROCESS_ID /
    CLARK_TPU_COORDINATOR, else torchrun's WORLD_SIZE / RANK /
    MASTER_ADDR:MASTER_PORT, else a world of one on a free local port."""
    env = os.environ
    if num_processes is None:
        if env.get("CLARK_TPU_NUM_PROCESSES"):
            num_processes = int(env["CLARK_TPU_NUM_PROCESSES"])
            process_id = (int(env.get("CLARK_TPU_PROCESS_ID", "0"))
                          if process_id is None else process_id)
        elif env.get("WORLD_SIZE"):
            num_processes = int(env["WORLD_SIZE"])
            process_id = (int(env.get("RANK", "0")) if process_id is None
                          else process_id)
        else:
            num_processes = 1
    process_id = 0 if process_id is None else process_id
    coordinator = coordinator or env.get("CLARK_TPU_COORDINATOR")
    if not coordinator and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if not coordinator:
        if num_processes > 1:
            raise ValueError(
                f"a world of {num_processes} processes needs a coordinator "
                "address (host:port): [cluster] coordinator_address or "
                "CLARK_TPU_COORDINATOR")
        coordinator = f"127.0.0.1:{_free_port()}"
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside a world of "
                         f"{num_processes}")
    return coordinator, num_processes, process_id


def backend_for(device) -> str:
    """The labels' backend: NCCL for CUDA devices, gloo for the CPU, or
    CLARK_TPU_DIST_BACKEND where set (gloo also reduces CUDA tensors,
    staged through the host)."""
    kind = torch.device(device).type
    want = os.environ.get("CLARK_TPU_DIST_BACKEND")
    if want:
        if want not in BACKENDS:
            raise ValueError(f"CLARK_TPU_DIST_BACKEND={want!r}: nccl or gloo")
        if want == "nccl" and kind != "cuda":
            raise ValueError("the nccl backend needs CUDA devices")
        return want
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device {device!r} (cuda or cpu)")


def local_rank() -> int | None:
    """torchrun's LOCAL_RANK, this process's place on its host, where set."""
    v = os.environ.get("LOCAL_RANK")
    return int(v) if v else None


def local_device(device="cuda") -> torch.device:
    """The card a process of the world drives for `device`: the one it
    names, else cuda:LOCAL_RANK under torchrun, else cuda:0."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", local_rank() or 0)


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> str:
    """Join the world (see world_from_env) over `device`'s backend;
    returns the backend.  On CUDA the process's current device becomes
    local_device(device), whose card NCCL uses."""
    global _host_group
    coordinator, n, rank = world_from_env(coordinator, num_processes,
                                          process_id)
    backend = backend_for(device)
    dev = local_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (torch.cuda.is_available() "
                               "is false)")
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator}",
                            world_size=n, rank=rank, timeout=timeout)
    _host_group = dist.new_group(backend="gloo", timeout=timeout)
    return backend


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum t over the world in place (the labels' backend); returns t."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def agree_max(n: int) -> int:
    """The largest of every process's n."""
    if not is_initialized():
        return int(n)
    t = torch.tensor([int(n)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group)
    return int(t.item())


def allgather_bytes(payload: bytes) -> list[bytes]:
    """Every process's byte string, in process order: the processes agree
    on the longest length, then each pads its payload to it (nothing is
    cut)."""
    if not is_initialized():
        return [bytes(payload)]
    n = process_count()
    ln = torch.tensor([len(payload)], dtype=torch.int64)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lens, ln, group=_host_group)
    lens = [int(x.item()) for x in lens]
    cap = max(max(lens), 1)
    buf = torch.zeros(cap, dtype=torch.uint8)
    buf[: len(payload)] = torch.from_numpy(
        np.frombuffer(payload, dtype=np.uint8).copy())
    rows = [torch.zeros(cap, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(rows, buf, group=_host_group)
    return [bytes(r[:m].numpy()) for r, m in zip(rows, lens)]


def shutdown() -> None:
    """Leave the world (destroy_process_group); a no-op outside one."""
    global _host_group
    if is_initialized():
        dist.destroy_process_group()
    _host_group = None
