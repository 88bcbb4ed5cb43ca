"""Worlds of ranks on torch.distributed: the counterpart of the JAX
package's meshes (`jax.sharding.Mesh`, `shard_map`, `ppermute`,
`process_allgather`).

A world is `world` processes of one host, started with the spawn method
(CUDA cannot be forked) and joined over a TCP store on a free local port.
Rank r runs on cuda:(r % device_count), or on the CPU when the caller
passes device="cpu".  The backend is NCCL only when every rank has a GPU
of its own; ranks that share a card, and ranks on the CPU, use gloo,
whose point-to-point and gather collectives move host tensors: halo rows
and payloads then travel through host memory while every pixel of compute
stays on the rank's device.  Nothing falls back: a failed init, a missing
card or a failed rank raises.
"""
from __future__ import annotations

import datetime
import queue
import socket
from typing import Callable, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from schroedinger_tpu_torch.devices import resolve_device

# how long a collective may wait for a peer before the world fails
TIMEOUT = datetime.timedelta(minutes=10)


def free_port() -> int:
    """A TCP port free on this host at the time of the call."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(rank: int, device=None) -> torch.device:
    """The device of `rank`: the CPU when `device` is the CPU, else
    cuda:(rank % device_count) (RuntimeError where there is no card)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"a rank runs on a CUDA device or the CPU, not "
                         f"{dev}")
    return torch.device("cuda", rank % torch.cuda.device_count())


def choose_backend(world: int, dev: torch.device) -> str:
    """NCCL when the ranks are on CUDA devices and each has one of its own
    (NCCL refuses two ranks on one GPU); gloo otherwise."""
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init(rank: int, world: int, addr: str, device=None) -> torch.device:
    """Join the world at `addr` (tcp://host:port) as `rank`; returns the
    rank's device.  Rank 0 prints the backend chosen."""
    dev = rank_device(rank, device)
    backend = choose_backend(world, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=addr, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    if rank == 0:
        print(f"world of {world} ranks: backend {backend}, rank 0 on {dev}",
              flush=True)
    return dev


def _rank_main(rank, fn, world, addr, device, args, results):
    dev = init(rank, world, addr, device)
    try:
        out = fn(rank, world, dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    results.put((rank, out))


def run_world(fn: Callable, world: int, *args, device=None) -> list:
    """Run fn(rank, world, device, *args) on every rank of a new world of
    `world` processes; returns the ranks' results in rank order.  `fn`
    and its arguments and result travel by pickle (`fn` by its import
    path).  A rank that raises ends the world: the others are terminated
    and this raises (torch.multiprocessing.ProcessRaisedException)."""
    results = mp.get_context("spawn").Queue()
    addr = f"tcp://127.0.0.1:{free_port()}"
    procs = mp.start_processes(
        _rank_main, args=(fn, world, addr, device, args, results),
        nprocs=world, join=False, start_method="spawn")
    out = {}

    def drain():
        while True:
            try:
                rank, val = results.get_nowait()
            except queue.Empty:
                return
            out[rank] = val

    # drain while joining: a rank's result must leave its pipe before it
    # can exit
    while not procs.join(timeout=0.2):
        drain()
    while len(out) < world:
        rank, val = results.get(timeout=60)
        out[rank] = val
    return [out[r] for r in range(world)]


def exchange_rows(x, n_prev: int, n_next: int):
    """(head, tail) of the row-sharded tile x (..., h, w) of this rank:
    head holds the previous rank's last n_prev rows, tail the next rank's
    first n_next rows, so cat([head, x, tail], -2) is x's part of the
    whole array with its neighbours.  Past the whole array's first and
    last row the edge row repeats (the taps' clamp).  One
    batch_isend_irecv for the call; NCCL sends x's device tensors, gloo
    host copies (it sends no CUDA tensors).  In a world of several ranks
    every tile needs at least max(n_prev, n_next) rows."""
    h = x.shape[-2]
    rank, world = dist.get_rank(), dist.get_world_size()
    if world > 1 and h < max(n_prev, n_next):
        raise ValueError(f"a tile of {h} rows cannot give {n_prev} + "
                         f"{n_next} halo rows")
    host = dist.get_backend() != "nccl"
    wire_dev = torch.device("cpu") if host else x.device

    def send(rows, peer):
        t = rows.contiguous()
        return dist.P2POp(dist.isend, t.cpu() if host else t, peer)

    def buffer(n):
        return torch.empty(x.shape[:-2] + (n, x.shape[-1]), dtype=x.dtype,
                           device=wire_dev)

    ops = []
    head = tail = None
    if n_prev and rank + 1 < world:
        ops.append(send(x[..., h - n_prev:, :], rank + 1))
    if n_prev and rank > 0:
        head = buffer(n_prev)
        ops.append(dist.P2POp(dist.irecv, head, rank - 1))
    if n_next and rank > 0:
        ops.append(send(x[..., :n_next, :], rank - 1))
    if n_next and rank + 1 < world:
        tail = buffer(n_next)
        ops.append(dist.P2POp(dist.irecv, tail, rank + 1))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def edge(rows, i, n):
        if rows is not None:
            return rows.to(x.device)
        reps = [-1] * x.ndim
        reps[-2] = n
        return x[..., i:i + 1, :].expand(reps)

    return edge(head, 0, n_prev), edge(tail, h - 1, n_next)


def allgather(arr: np.ndarray) -> np.ndarray:
    """Every rank's numpy array (one shape and dtype on every rank),
    stacked in rank order: the counterpart of JAX's process_allgather.
    The array travels as its bytes (gloo gathers no int16)."""
    arr = np.ascontiguousarray(arr)
    t = torch.from_numpy(arr.reshape(-1).view(np.uint8))
    if dist.get_backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    world = dist.get_world_size()
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t)
    out = torch.stack(parts).cpu().numpy()
    return out.view(arr.dtype).reshape((world,) + arr.shape)


def allgather_bytes(data: bytes, gather=allgather) -> List[bytes]:
    """Every rank's bytes in rank order, through two gathers: the lengths,
    then the payloads zero-padded to the longest.  `gather` is
    `allgather` or a stand-in with its contract (an array in, the ranks'
    arrays stacked out)."""
    lens = gather(np.asarray([len(data)], np.int64))
    buf = np.zeros(int(lens.max()), np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    allbuf = gather(buf)
    return [allbuf[i, :int(lens[i, 0])].tobytes() for i in range(len(lens))]
