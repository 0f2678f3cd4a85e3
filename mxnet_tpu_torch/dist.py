"""The multi-process runtime: one process per GPU over ``torch.distributed``.

Counterpart: ``mxnet_tpu/dist.py`` (:76-158).  The JAX package runs one
controller process per host over ``jax.distributed`` and one mesh over
every chip it sees.  The port runs ONE PROCESS PER DEVICE, the PyTorch
idiom (a deliberate departure): one Python thread launching every
replica's kernels would make the eager step host-bound at any scale.
The processes join one process group (NCCL on the card; gloo on the CPU,
or by name) and a ``parallel.mesh`` names that group as its ``dp`` axis.

Env contract, the JAX package's (``tools/launch.py --launcher jax`` or
``python -m mxnet_tpu_torch.dist -n N <cmd>`` export it):

  MXNET_COORDINATOR_ADDRESS  host:port of rank 0's rendezvous
  MXNET_NUM_PROCESSES        number of processes (= devices)
  MXNET_PROCESS_ID           this process's rank (0-based)

Rank r drives card ``r % (visible cards)``.  Every collective of the
group has a timeout (``COLLECTIVE_TIMEOUT_S``), so a dead or hung rank
fails the run instead of hanging it.
"""
from __future__ import annotations

import argparse
import datetime
import os
import queue as _queue
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as _tdist

from . import env as _env

__all__ = ["initialize", "is_initialized", "shutdown", "rank",
           "num_processes", "local_devices", "global_devices", "device",
           "free_port", "env_spec", "launch", "main"]

#: seconds before a collective that a rank never joins fails the run
COLLECTIVE_TIMEOUT_S = 600.0

# what initialize() learned about this process and its peers
_info: dict = {}


def free_port() -> int:
    """An OS-assigned free TCP port on this host."""
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def env_spec():
    """The (coordinator, num_processes, process_id) triple from the env,
    or None when no multi-process launch is configured."""
    addr = _env.get_str("MXNET_COORDINATOR_ADDRESS")
    if not addr:
        return None
    # a malformed value raises here instead of training alone
    return (addr, int(os.environ["MXNET_NUM_PROCESSES"]),
            int(os.environ["MXNET_PROCESS_ID"]))


def _resolve(backend: Optional[str], device, process_id: int):
    """(backend, torch.device) for this process.  NCCL on a card unless
    the caller asks for the CPU or for gloo by name (gloo runs on the
    card where there is one, else on the CPU); no card and no such
    request raises."""
    dev = None if device is None else torch.device(device)
    if dev is None and backend == "gloo" and not torch.cuda.is_available():
        dev = torch.device("cpu")
    if backend is None:
        backend = "gloo" if dev is not None and dev.type == "cpu" \
            else "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError("dist.initialize: backend %r (nccl or gloo)"
                         % (backend,))
    if dev is None or dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dist.initialize: no CUDA device is visible for the %s "
                "process group; pass device='cpu' (gloo on the CPU)"
                % backend)
        if dev is None or dev.index is None:
            dev = torch.device("cuda",
                               process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("dist.initialize: NCCL runs on CUDA devices, "
                         "not on %s" % dev)
    return backend, dev


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device=None,
               init_method: Optional[str] = None) -> bool:
    """Join the process group.  Arguments default to the MXNET_* env
    contract; returns False (a no-op) when neither is given, True once a
    group exists.  ``init_method`` (e.g. ``file:///tmp/rdv``) replaces
    the coordinator's ``tcp://host:port``.  ``device``: this process's
    device (default: its card; ``"cpu"`` selects gloo on the CPU)."""
    if _tdist.is_initialized():
        return True
    if coordinator_address is None and init_method is None:
        spec = env_spec()
        if spec is None:
            return False
        coordinator_address, num_processes, process_id = spec
    if num_processes is None or process_id is None:
        raise ValueError("initialize() needs num_processes and process_id "
                         "beside the rendezvous address")
    backend, dev = _resolve(backend, device, int(process_id))
    _tdist.init_process_group(
        backend, init_method=init_method or "tcp://" + coordinator_address,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    peers: List[Any] = [None] * int(num_processes)
    _tdist.all_gather_object(peers, (socket.gethostname(), str(dev)))
    _info.update(device=dev, hosts=[h for h, _ in peers],
                 devices=[torch.device(d) for _, d in peers])
    return True


def is_initialized() -> bool:
    return _tdist.is_initialized()


def shutdown() -> None:
    if _tdist.is_initialized():
        _tdist.destroy_process_group()
    _info.clear()


def rank() -> int:
    return _tdist.get_rank() if _tdist.is_initialized() else 0


def num_processes() -> int:
    return _tdist.get_world_size() if _tdist.is_initialized() else 1


def device() -> torch.device:
    """This process's device: the one ``initialize`` chose, else the
    current card."""
    if "device" in _info:
        return _info["device"]
    if not torch.cuda.is_available():
        raise RuntimeError("dist.device: no process group and no CUDA "
                           "device; pass device='cpu' where you build")
    return torch.device("cuda", torch.cuda.current_device())


def local_devices() -> List[torch.device]:
    """The device this process drives (one per process)."""
    return [device()]


def global_devices() -> List[torch.device]:
    """Every rank's device, in rank order."""
    return list(_info.get("devices") or local_devices())


def hosts() -> List[str]:
    """Every rank's host name, in rank order."""
    return list(_info.get("hosts") or [socket.gethostname()])


# ---------------------------------------------------------------------------
# launch: N ranks of a Python function (spawn) or of a command
# ---------------------------------------------------------------------------
def _rank_main(fn, rank_id, n, init_method, backend, dev, threads, args,
               queue):
    try:
        if threads:
            torch.set_num_threads(int(threads))
        initialize(init_method=init_method, num_processes=n,
                   process_id=rank_id, backend=backend, device=dev)
        result = fn(*args)
        queue.put((rank_id, True, result))
    except BaseException:
        queue.put((rank_id, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def launch(fn: Callable, nprocs: int, args: Sequence = (), *,
           backend: Optional[str] = None, device=None,
           timeout_s: float = 600.0, threads: Optional[int] = None) -> list:
    """Run ``fn(*args)`` on ``nprocs`` ranks, each a process started with
    the ``spawn`` method that joins one process group first (rendezvous
    through a file in a fresh temporary directory; ``threads`` caps each
    rank's torch threads).  Returns the ranks' results in rank order.  A rank that raises, exits non-zero or does not report within
    ``timeout_s`` fails the launch: the others are stopped and the error
    names the rank (no rank's failure is dropped)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mxdist_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, nprocs, init_method, backend, device,
                               threads, tuple(args), queue), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + float(timeout_s)
    try:
        while len(results) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    "dist.launch: rank(s) %s did not finish in %.0f s"
                    % (sorted(set(range(nprocs)) - set(results)),
                       timeout_s))
            try:
                r, ok, value = queue.get(timeout=min(left, 1.0))
            except _queue.Empty:  # see whether a rank died
                dead = [i for i, p in enumerate(procs)
                        if i not in results and p.exitcode not in (None,
                                                                     0)]
                if dead:
                    raise RuntimeError(
                        "dist.launch: rank %d exited with code %s before "
                        "reporting" % (dead[0], procs[dead[0]].exitcode))
                continue
            if not ok:
                raise RuntimeError("dist.launch: rank %d failed:\n%s"
                                   % (r, value))
            results[r] = value
        for i, p in enumerate(procs):
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise RuntimeError("dist.launch: rank %d exited with code "
                                   "%s" % (i, p.exitcode))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(nprocs)]


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def run_command(nprocs: int, cmd: Sequence[str],
                timeout_s: Optional[float] = None) -> int:
    """Start ``cmd`` as ``nprocs`` ranks with the env contract (a fresh
    interpreter each, as ``spawn``).  Returns 0 when every rank exits 0;
    else the first failing rank's code (the others are stopped), or 124
    at the timeout."""
    coord = "127.0.0.1:%d" % free_port()
    procs = []
    for r in range(nprocs):
        e = dict(os.environ, MXNET_COORDINATOR_ADDRESS=coord,
                 MXNET_NUM_PROCESSES=str(nprocs), MXNET_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(list(cmd), env=e))
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                print("mxnet_tpu_torch.dist: rank %d exited with code %d; "
                      "stopping the others" % (codes.index(bad[0]), bad[0]),
                      file=sys.stderr)
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                print("mxnet_tpu_torch.dist: timed out", file=sys.stderr)
                return 124
            time.sleep(0.1)
    finally:
        _stop(procs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.dist",
        description="Start a command as N ranks, one process per GPU, "
                    "with the MXNET_* env contract that "
                    "dist.initialize() reads.")
    ap.add_argument("-n", "--num-processes", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds before every rank is stopped (exit 124)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command to launch")
    return run_command(args.num_processes, args.command, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
