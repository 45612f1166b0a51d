"""The processes of a kind that runs on several cards, one a card.

Rank 0 is the benchmark's own process: the one that ``record`` traces,
that times the window and prints the result.  Ranks 1..n-1 are spawned
by rank 0 at set-up (``Ranks``), each a new interpreter on its own card,
and serve rank 0's commands (``serve``) until it tells them to stop.
Beside the program's own process group (NCCL on the card, gloo on the
CPU) every rank joins a gloo group on the host, the command channel:
rank 0 broadcasts a command and its argument, and gathers reports
(numbers a rank sends back, one row each).

A rank that dies or stalls ends the run with an error and never hangs
it: rank 0's watchdog thread kills every spawned rank and exits the
process with ``EXIT_CODE`` when a spawned rank exits unasked, or when
rank 0 has made no progress (``beat``) for ``stall_s`` seconds; a
spawned rank exits when its standard input closes, which it does when
rank 0 is gone.  Collectives of both groups time out after twice
``stall_s``, so that the watchdog, which names the fault, ends the run
first.
"""

from __future__ import annotations

import atexit
import datetime
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List

import torch
import torch.distributed as dist

# the checkout's root: the folder that holds the benchmark and the program
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EXIT_CODE = 3
STOP = 0  # the command that ends ``serve``


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join(rank: int, world: int, port: int, device, stall_s: float):
    """Join the program's process group (NCCL on a card, gloo on the CPU)
    as ``rank`` of ``world`` at ``tcp://127.0.0.1:<port>``, with this
    rank's card current; returns the command channel, a gloo group of the
    same ranks; both groups' collectives time out after 2 ``stall_s``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())
    timeout = datetime.timedelta(seconds=2 * stall_s)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=timeout)
    return dist.new_group(backend="gloo", timeout=timeout)


def leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def broadcast(channel, cmd: int = 0, arg: int = 0):
    """Rank 0 sends (cmd, arg); every other rank receives it."""
    t = torch.tensor([cmd, arg], dtype=torch.int64)
    dist.broadcast(t, 0, group=channel)
    return int(t[0]), int(t[1])


def report(channel, values: List[float]) -> List[List[float]]:
    """Every rank's ``values`` (the same length on each), by rank."""
    rows = torch.zeros((dist.get_world_size(channel), len(values)), dtype=torch.float64)
    rows[dist.get_rank(channel)] = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(rows, group=channel)
    return rows.tolist()


def serve(channel, handlers: Dict[int, Callable[[int], None]], until: int = STOP) -> None:
    """A spawned rank's loop: run the handler of each command rank 0
    broadcasts, with its argument, until the command ``until``."""
    while True:
        cmd, arg = broadcast(channel)
        if cmd == until:
            return
        handlers[cmd](arg)


def exit_when_orphaned() -> None:
    """In a spawned rank: exit at once when standard input closes (rank 0
    has ended, or killed this rank's pipe)."""
    def watch():
        sys.stdin.buffer.read()
        os._exit(EXIT_CODE)

    threading.Thread(target=watch, daemon=True).start()


class Ranks:
    """Rank 0's handle on the spawned ranks 1..world-1, each started by
    ``argv(rank, port)`` from the checkout's root (their standard output
    goes to this process's standard error, so that rank 0's last line is
    the result)."""

    def __init__(self, argv: Callable[[int, int], List[str]], world: int, stall_s: float):
        self.world, self.stall_s = world, stall_s
        self.port = free_port()
        self.closing = False
        self._last = time.monotonic()
        self.procs = [subprocess.Popen(argv(r, self.port), stdin=subprocess.PIPE,
                                       stdout=sys.stderr.fileno(), cwd=ROOT)
                      for r in range(1, world)]
        atexit.register(self.kill)
        self._watch = threading.Thread(target=self._watchdog, daemon=True)
        self._watch.start()

    def beat(self) -> None:
        """Rank 0 has made progress."""
        self._last = time.monotonic()

    def _watchdog(self) -> None:
        while not self.closing:
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc is not None and not self.closing:
                    self._fail(f"rank {r} exited with code {rc} before the run ended")
            if time.monotonic() - self._last > self.stall_s:
                self._fail(f"no progress for {self.stall_s:.0f} s: a rank stalled")
            time.sleep(0.25)

    def _fail(self, why: str) -> None:
        print(f"multi-card run failed: {why}; ending every rank", file=sys.stderr, flush=True)
        self.kill()
        os._exit(EXIT_CODE)

    def kill(self) -> None:
        self.closing = True
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def close(self, channel, timeout_s: float = 60.0) -> None:
        """Tell every spawned rank to stop, leave the groups with them (NCCL
        tears a communicator down on every rank together), and wait for
        each to end, killing any that has not within ``timeout_s``."""
        self.closing = True
        broadcast(channel, STOP)
        leave()
        deadline = time.monotonic() + timeout_s
        late = []
        for r, p in enumerate(self.procs, 1):
            try:
                rc = p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                late.append(r)
                continue
            if rc != 0:
                late.append(r)
        self.kill()
        for p in self.procs:
            p.stdin.close()
        if late:
            raise RuntimeError(f"ranks {late} did not stop cleanly")
