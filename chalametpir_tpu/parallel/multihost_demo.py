"""Two-process (multi-host) PIR demo: sharded setup + collective respond.

Runs the full protocol with the encoded DB sharded across the devices of
MULTIPLE processes — the hint and respond reductions cross the process
boundary as real collectives (gloo on the CPU scaffold, NCCL across GPU
hosts). Every process executes this same script (SPMD); the client lives on
process 0 and its query is broadcast before the collective respond.

CPU scaffold (what tests/test_multihost.py drives):

    python -m chalametpir_tpu.parallel.multihost_demo --launch 2

spawns 2 child processes x 4 virtual CPU devices = an 8-device global
mesh split across processes. GPU hosts run the same flow with
`--coordinator/--num-processes/--process-id` given to each process and
no --cpu flag.

Online-serving mode (`--tcp-queries N [--port-file P]`): process 0
additionally runs the reference-framed TCP server; every respond batch
is broadcast to the workers and answered as one SPMD collective, so an
unmodified external `net.client` retrieves values from the sharded DB.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def _parse():
    ap = argparse.ArgumentParser()
    ap.add_argument("--launch", type=int, default=0, metavar="N",
                    help="launcher mode: spawn N worker processes and wait")
    # all three are required on GPU and CPU hosts; the CPU launcher
    # passes them explicitly to its workers
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=240,
                    help="launcher: seconds before the workers are killed")
    ap.add_argument("--cpu-devices", type=int, default=4,
                    help="virtual CPU devices per process (0 = real backend)")
    ap.add_argument("--entries", type=int, default=300)
    ap.add_argument("--tcp-queries", type=int, default=0, metavar="N",
                    help="online-serving mode: process 0 serves TCP until "
                         "N queries are answered (each respond batch is an "
                         "SPMD collective across all processes)")
    ap.add_argument("--port-file", default=None,
                    help="tcp mode: write the bound port here for the caller")
    return ap.parse_args()


def launch(args) -> int:
    """Spawn the workers and wait, with a deadline; exit code is nonzero
    if any worker fails. A worker that wedges (e.g. one peer died before
    the collectives formed, the other blocks in gloo) is killed at the
    deadline instead of hanging the launcher's caller forever."""
    import time

    coordinator = args.coordinator or "127.0.0.1:29811"
    procs = []
    for pid in range(args.launch):
        cmd = [
            sys.executable, "-m", "chalametpir_tpu.parallel.multihost_demo",
            "--coordinator", coordinator,
            "--num-processes", str(args.launch),
            "--process-id", str(pid),
            "--cpu-devices", str(args.cpu_devices),
            "--entries", str(args.entries),
            # workers size their warmup barrier from --timeout; without
            # forwarding it they'd fall back to the default and cap the
            # very headroom a raised launcher deadline was meant to add
            "--timeout", str(args.timeout),
        ]
        if args.tcp_queries:
            cmd += ["--tcp-queries", str(args.tcp_queries)]
            if args.port_file and pid == 0:
                cmd += ["--port-file", args.port_file]
        procs.append(subprocess.Popen(cmd))
    deadline = time.monotonic() + args.timeout
    rc = 0
    try:
        for p in procs:
            remaining = max(0.1, deadline - time.monotonic())
            try:
                rc |= p.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                rc |= 124
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            if p.poll() is None:
                p.wait()
    return rc


def worker(args) -> None:
    if args.cpu_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={args.cpu_devices}"
            ).strip()
    import jax

    if args.cpu_devices:
        # virtual CPU devices: pin the platform even where an
        # accelerator is present
        jax.config.update("jax_platforms", "cpu")

    from . import multihost

    multihost.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    pid = jax.process_index()
    print(f"[p{pid}] joined: {len(jax.local_devices())} local / "
          f"{len(jax.devices())} global devices", flush=True)
    # form the global communicator while the processes are aligned —
    # otherwise the first collective (the hint psum inside setup) only
    # happens after each process independently compiles the sharded
    # program, and on a contended host that skew can blow gloo's ~30 s
    # rendezvous window (see multihost.warmup_collectives)
    multihost.warmup_collectives(timeout_s=args.timeout)
    print(f"[p{pid}] collectives warmed", flush=True)

    import numpy as np

    from ..models.client import Client
    from ..models.server import Server
    from ..utils import generate_random_kv_database

    # identical inputs on every process (SPMD determinism contract)
    rng = np.random.default_rng(0xD157)
    db = generate_random_kv_database(args.entries, rng=rng,
                                     value_byte_len=(1, 64))
    seed = bytes(range(32))
    mesh = multihost.make_multihost_mesh(model=len(jax.devices()))
    server, hint, fparams = Server.setup(
        seed, db, arity=3, mesh=mesh, prg_mode="ctr",
        rng=np.random.default_rng(1),
    )
    print(f"[p{pid}] sharded setup done (m={server.num_query_cols})", flush=True)

    if args.tcp_queries:
        _serve_tcp(args, pid, server, seed, hint, fparams)
        return

    from ..errors import ArithmeticOverflowAddingQueryIndicator

    key = sorted(db)[len(db) // 2]
    if pid == 0:
        client = Client.setup(seed, hint, fparams, prg_mode="ctr", device=False)
        while True:
            try:
                q_bytes = client.query(key)
                break
            except ArithmeticOverflowAddingQueryIndicator:
                continue
    else:
        client, q_bytes = None, None

    # wire length is deterministic on every process: 8-byte header + m u32
    wire_len = 8 + 8 + 4 * server.num_query_cols
    q_bytes = multihost.broadcast_query(q_bytes, max_len=wire_len)
    resp = server.respond(q_bytes)  # collective: psum crosses processes

    if pid == 0:
        value = client.process_response(key, resp)
        assert value == db[key], "multihost retrieval mismatch"
        print("MULTIHOST OK", flush=True)
    print(f"[p{pid}] done", flush=True)


def _serve_tcp(args, pid, server, seed, hint, fparams) -> None:
    """Online-serving mode: the leader runs the reference-framed TCP
    surface, each respond batch broadcast to the workers and answered as
    one SPMD collective; workers sit in the respond loop until the
    leader has served --tcp-queries queries and broadcasts shutdown."""
    from . import multihost

    if pid != 0:
        multihost.worker_respond_loop(server)
        print(f"[p{pid}] worker loop done", flush=True)
        return

    import asyncio

    from ..net.server import PirTcpServer

    tcp = PirTcpServer(
        server, seed, hint, fparams,
        respond_batch_fn=multihost.leader_respond_batch_fn(server),
        max_batch=multihost.DEFAULT_SERVE_BATCH,
    )

    async def serve():
        srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        if args.port_file:
            tmp = args.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(port))
            os.replace(tmp, args.port_file)  # atomic: readers never see ""
        print(f"TCP_PORT={port}", flush=True)
        async with srv:
            while tcp._dispatcher.served < args.tcp_queries:
                await asyncio.sleep(0.05)
        # quiesce BEFORE the shutdown broadcast: aclose() guarantees no
        # batch broadcast is running or can start, so the shutdown
        # collective below is strictly ordered after every batch
        # collective (a late extra query gets a clean ConnectionError).
        # Then wait for the handler tasks to finish FLUSHING the
        # responses the dispatcher produced — a fixed grace sleep lost
        # the final frame to asyncio.run teardown cancelling a handler
        # mid-write on a contended host
        await tcp._dispatcher.aclose()
        if not await tcp.wait_idle(timeout=10.0):
            print("warning: connections still active at shutdown",
                  file=sys.stderr, flush=True)

    asyncio.run(serve())
    multihost.broadcast_shutdown(
        multihost._batch_max_len(server, multihost.DEFAULT_SERVE_BATCH)
    )
    print("MULTIHOST TCP OK", flush=True)


def main() -> None:
    args = _parse()
    if args.launch:
        sys.exit(launch(args))
    worker(args)


if __name__ == "__main__":
    main()
