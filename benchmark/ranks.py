"""One process a card: the launcher of a multi-card cell's ranks and each
rank's joining of the process group.

A run of a cell whose ``chips`` is above 1 starts that many ranks, each a
child process of the same script with the private arguments ``--rank``,
``--world`` and ``--t-before`` (the launcher's seconds since its start,
which rank 0 adds to its own set-up), and ``MASTER_ADDR`` 127.0.0.1 and a
free ``MASTER_PORT`` in its environment. The launcher relays what the ranks
write to standard error, each line of rank r > 0 behind ``[rank r]``, and
keeps what they write to standard output. It ends every rank, and the
processes each started, once one rank exits with another code than 0 or
once no rank has written a line for ``stall_s`` seconds, and then fails;
it hands back rank 0's last line of standard output only once every rank
has exited with 0.
"""

from __future__ import annotations

import ctypes
import os
import selectors
import signal
import socket
import subprocess
import sys
import time
from datetime import timedelta
from typing import Callable, List, Optional, Tuple

# seconds without a line from any rank after which the launcher ends them
STALL_S = 240.0
# seconds a rank has to end after SIGTERM, before SIGKILL
GRACE_S = 10.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# prctl's PR_SET_PDEATHSIG: the signal a child gets once its parent is gone
PR_SET_PDEATHSIG = 1


def _die_with_parent():
    """A preexec_fn that makes the child get SIGKILL once the launcher is
    gone; libc's prctl is looked up before the fork, so that the child
    only calls it."""
    prctl = ctypes.CDLL(None).prctl
    return lambda: prctl(PR_SET_PDEATHSIG, signal.SIGKILL)


def _end(procs: List[subprocess.Popen]) -> None:
    """SIGTERM to each rank's process group (what is left of it once the
    rank has exited, too), SIGKILL after GRACE_S, and waits for each."""
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for p in procs:
            try:
                os.killpg(p.pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + GRACE_S
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        if all(p.poll() is not None for p in procs):
            return


def launch(command: Callable[[int], List[str]], world: int,
           stall_s: float = STALL_S, relay_all: bool = False
           ) -> Tuple[int, Optional[str]]:
    """Runs ``command(rank)`` for each of ``world`` ranks and supervises
    them (the module's note). Returns (0, rank 0's last line of standard
    output) when every rank exited with 0; else (a code that is not 0,
    None). With ``relay_all`` each line of rank 0's standard output is
    printed as it comes."""
    out, err = sys.stdout, sys.stderr
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    sel = selectors.DefaultSelector()
    procs: List[subprocess.Popen] = []
    last: Optional[str] = None
    partial = {}

    def on_term(signum, frame):
        raise SystemExit(128 + signum)
    previous = signal.signal(signal.SIGTERM, on_term)
    die_with_parent = _die_with_parent()
    try:
        for rank in range(world):
            p = subprocess.Popen(command(rank), env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE,
                                 start_new_session=True,
                                 preexec_fn=die_with_parent)
            procs.append(p)
            sel.register(p.stdout, selectors.EVENT_READ, (rank, "out"))
            sel.register(p.stderr, selectors.EVENT_READ, (rank, "err"))
        seen = time.monotonic()
        open_pipes = 2 * world
        while True:
            for key, _ in sel.select(timeout=1.0):
                rank, which = key.data
                chunk = os.read(key.fileobj.fileno(), 1 << 16)
                if not chunk:
                    sel.unregister(key.fileobj)
                    open_pipes -= 1
                    chunk = b"\n" if partial.get(key.data) else b""
                seen = time.monotonic()
                text = partial.pop(key.data, b"") + chunk
                *lines, rest = text.split(b"\n")
                if rest:
                    partial[key.data] = rest
                for raw in lines:
                    line = raw.decode(errors="replace")
                    if which == "out" and rank == 0:
                        if relay_all:
                            print(line, file=out, flush=True)
                        if line.strip():
                            last = line
                    else:
                        tag = f"[rank {rank}] " if rank else ""
                        print(tag + line, file=err, flush=True)
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes)
                      if c not in (None, 0)]
            if failed:
                print(f"rank {failed[0][0]} exited with code "
                      f"{failed[0][1]}; ending every rank", file=err,
                      flush=True)
                return 5, None
            if all(c == 0 for c in codes) and open_pipes == 0:
                break
            if time.monotonic() - seen > stall_s:
                print(f"no rank wrote a line for {stall_s:.0f} s; ending "
                      "every rank", file=err, flush=True)
                return 6, None
        if last is None:
            print("rank 0 printed no result", file=err, flush=True)
            return 5, None
        return 0, last
    finally:
        _end(procs)
        for p in procs:
            for pipe in (p.stdout, p.stderr):
                pipe.close()
        sel.close()
        signal.signal(signal.SIGTERM, previous)


def launch_built(command: Callable[[int], List[str]], world: int,
                 **kw) -> Tuple[int, Optional[str]]:
    """``launch`` once the program's kernels are built, so that the ranks
    load one library and none of them builds it."""
    from fr_tpu_torch.ops import _build
    _build.build()
    return launch(command, world, **kw)


def join(rank: int, world: int, backend: str):
    """Joins the process group over MASTER_ADDR/MASTER_PORT as ``rank`` of
    ``world`` and returns this rank's device: ``cuda:<rank>``, made the
    current one, under NCCL; the CPU under gloo."""
    import torch
    import torch.distributed as dist

    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=600))
    return device


def mesh_loops(files: dict, rank: int, world: int, backend: str):
    """Joins the group as ``rank`` of ``world`` (``join``), builds the mesh
    of the cell's ``deployment.mesh`` on it and returns ``make(seed)``,
    which gives the traffic's mesh loop on this rank's device."""
    from benchmark import harness
    from fr_tpu_torch.parallel.mesh import make_mesh

    device = join(rank, world, backend)
    shape = files["config"]["deployment"]["mesh"]
    if shape["data"] * shape["model"] != world:
        raise harness.BenchError(f"the mesh {shape} is not {world} ranks")
    mesh = make_mesh(shape["data"], shape["model"])
    loop = harness.loop_for(files["traffic"], mesh=True)
    return lambda seed: loop(files["config"], files["traffic"], seed,
                             device, mesh=mesh)
