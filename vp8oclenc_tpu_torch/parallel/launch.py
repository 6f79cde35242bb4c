"""Run a function on a spawned torch.distributed world, one process per
rank, and return rank 0's result.

    result = run(fn, world=4, backend="nccl", args=(...))

`fn(layout, *args)` runs on every rank with its parallel.mesh.Layout;
what rank 0 returns comes back.  The backend is the caller's choice:
"nccl" between distinct cards, "gloo" on the CPU or for ranks that share
a card.  The devices default to the card (ops/backend.resolve_device);
the CPU runs only when the caller asks for it.  Ranks reach each other
over a TCP store on localhost.  When a rank's device is a card, the parent builds the CUDA
libraries before it spawns anything, so that the ranks only load them and
no two processes race on the build directory.  A rank that raises or dies
ends the run: the others are terminated and the error is raised here.
On a machine that starts its ranks itself (torchrun), call
`init_rank` in each instead."""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import socket
import traceback

import torch
import torch.distributed as dist

from vp8oclenc_tpu_torch.ops.backend import resolve_device
from vp8oclenc_tpu_torch.parallel.mesh import Layout

# the init's process-group timeout, and how long run() waits for its ranks
PG_TIMEOUT_S = 600.0
RUN_TIMEOUT_S = PG_TIMEOUT_S + 300.0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_rank(backend: str, device, rank: int, world: int, addr: str,
              gop=None, tile=None, timeout_s: float = PG_TIMEOUT_S) -> Layout:
    """Join the world at `addr` ("tcp://host:port") and return this rank's
    Layout; a CUDA device becomes the rank's current device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=addr, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Layout(backend, dev, gop, tile)


def _rank_main(rank, world, addr, backend, device, gop, tile, threads, fn,
               args, out) -> None:
    try:
        torch.set_num_threads(threads)
        if backend == "gloo" and "lo" in (n for _, n in
                                          socket.if_nameindex()):
            # the world is on this machine: gloo's pairs over loopback,
            # whatever the host name resolves to
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        layout = init_rank(backend, device, rank, world, addr, gop, tile)
        result = fn(layout, *args)
        dist.barrier()
        dist.destroy_process_group()
        out.put((rank, "ok", result if rank == 0 else None))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
        raise


def run(fn, world: int, backend: str, devices=None, args=(), gop=None,
        tile=None):
    """fn(layout, *args) on `world` spawned ranks; rank 0's result.
    devices: one device for every rank (None: the card), or a list with
    one per rank."""
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = [devices] * world
    devices = [resolve_device(d) for d in devices]
    if len(devices) != world:
        raise ValueError("one device per rank")
    if any(d.type == "cuda" for d in devices):
        from vp8oclenc_tpu_torch.ops import cuda_build
        cuda_build.build_all()
    threads = max(1, (os.cpu_count() or 1) // world)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    addr = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, addr, backend, str(devices[r]), gop,
                               tile, threads, fn, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    result, done = None, set()
    deadline = datetime.datetime.now() + \
        datetime.timedelta(seconds=RUN_TIMEOUT_S)
    try:
        while len(done) < world:
            try:
                rank, status, payload = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in done]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                if datetime.datetime.now() > deadline:
                    left = sorted(set(range(world)) - done)
                    raise TimeoutError(f"ranks {left} did not finish in "
                                       f"{RUN_TIMEOUT_S} s")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            done.add(rank)
            if rank == 0:
                result = payload
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return result
