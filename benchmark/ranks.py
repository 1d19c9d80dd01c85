"""A cell on several cards: one process a card, joined over NCCL.

``run.py`` starts the ranks as copies of itself (``launch``), each with
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the TCP store's address in its
environment; rank 0 prints the result.  The helpers below are what the
harness needs of the group: one decision for all ranks, the largest and the
mean of a number over the ranks, and the ranks' particles gathered on
rank 0.  Without a group they are the one process's own values.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

TIMEOUT_S = 300


def free_port() -> int:
    """A TCP port of this machine that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: list, chips: int) -> int:
    """Run ``python argv...`` as ``chips`` ranks and wait for all of them;
    rank 0 keeps this process's standard output, the others write to its
    standard error.  Returns rank 0's exit code, or the first other rank's
    that failed."""
    port = free_port()
    procs = []
    for rank in range(chips):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(chips), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=env,
            stdout=None if rank == 0 else sys.stderr))
    try:
        codes = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [c for c in codes[1:] if c != 0]
    return codes[0] if codes[0] != 0 or not bad else bad[0]


def launched() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init(device_type: str):
    """Join the launcher's group (NCCL on cards, gloo on the CPU); returns
    this rank's device."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return device


def world() -> tuple[int, int]:
    """(rank, size) of the group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _reduce(x: float, op, device) -> float:
    t = torch.tensor([float(x)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=op)
    return float(t[0])


def any_rank(flag: bool, device) -> bool:
    """Whether ``flag`` holds on some rank: one decision for all."""
    if world()[1] == 1:
        return flag
    return _reduce(flag, dist.ReduceOp.MAX, device) > 0


def largest(x: float, device) -> float:
    return x if world()[1] == 1 else _reduce(x, dist.ReduceOp.MAX, device)


def mean(x: float, device) -> float:
    size = world()[1]
    return x if size == 1 else _reduce(x, dist.ReduceOp.SUM, device) / size


def gather_rows(t: torch.Tensor):
    """The ranks' (k_r, ...) tensors of one dtype, concatenated in rank
    order on rank 0 (None on the others)."""
    rank, size = world()
    if size == 1:
        return t
    if t.dtype == torch.bool:
        out = gather_rows(t.to(torch.uint8))
        return None if out is None else out.bool()
    n = torch.tensor([t.shape[0]], device=t.device)
    sizes = [torch.zeros_like(n) for _ in range(size)]
    dist.all_gather(sizes, n)
    most = int(max(int(s) for s in sizes))
    pad = torch.zeros((most - t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    parts = [torch.empty((most, *t.shape[1:]), dtype=t.dtype, device=t.device)
             for _ in range(size)]
    dist.all_gather(parts, torch.cat([t, pad]).contiguous())
    if rank != 0:
        return None
    return torch.cat([p[:int(s)] for p, s in zip(parts, sizes)])
