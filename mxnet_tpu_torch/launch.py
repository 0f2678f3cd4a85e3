"""The parameter-server cluster launcher on one host.

Counterpart: ``tools/launch.py`` ``launch_local`` (:42-108; ref:
tools/launch.py's local mode of the dmlc-core tracker): a scheduler,
``-s`` servers and ``-n`` workers as processes of this host, joined by
the DMLC_* env contract.  The scheduler and the servers run
``mxnet_tpu_torch.kvstore_server``; the workers run the command, which
creates a ``dist_sync`` / ``dist_async`` / ``dist_device_sync`` store::

    python -m mxnet_tpu_torch.launch -n 2 -s 1 python train.py --kv-store dist_sync

The launcher polls the workers: once one has failed, the others get a
15 s grace to finish, then are killed (a crashed worker would leave the
rest waiting at a barrier).  It exits with the largest worker exit code
and stops the scheduler and the servers.  The collective launcher (one
process a card over ``torch.distributed``) is ``python -m
mxnet_tpu_torch.dist``.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

__all__ = ["launch_local", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch_local(num_workers: int, num_servers: int, cmd, env=None,
                 grace_s: float = 15.0):
    """Start a scheduler, the servers and the workers on this host;
    returns the workers' exit codes once every worker has ended (the
    scheduler and the servers are stopped then)."""
    from .dist import free_port

    base_env = dict(os.environ)
    if env:
        base_env.update(env)
    base_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, base_env.get("PYTHONPATH")) if p)
    base_env.update({
        "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": str(free_port()),
        "DMLC_NUM_SERVER": str(num_servers),
        "DMLC_NUM_WORKER": str(num_workers),
    })

    def spawn(role, extra=None):
        e = dict(base_env)
        e["DMLC_ROLE"] = role
        e.update(extra or {})
        # the scheduler and the servers run the node loop, not the command
        argv = list(cmd) if role == "worker" else \
            [sys.executable, "-m", "mxnet_tpu_torch.kvstore_server"]
        return subprocess.Popen(argv, env=e)

    daemons = [spawn("scheduler")]
    daemons += [spawn("server") for _ in range(num_servers)]
    procs = [spawn("worker", {"DMLC_WORKER_ID": str(i)})
             for i in range(num_workers)]
    try:
        grace_until = None
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            if any(c is not None and c != 0 for c in codes):
                if grace_until is None:
                    grace_until = time.time() + grace_s
                elif time.time() > grace_until:
                    for p in procs:
                        if p.poll() is None:
                            p.kill()
                    codes = [p.wait() for p in procs]
                    break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for p in daemons:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    return codes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.launch",
        description="Start a parameter-server cluster on this host.")
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, default=None,
                    help="defaults to num-workers (like the reference)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    ns = args.num_servers if args.num_servers is not None \
        else args.num_workers
    codes = launch_local(args.num_workers, ns, args.command)
    return max(codes) if codes else 0


if __name__ == "__main__":
    sys.exit(main())
