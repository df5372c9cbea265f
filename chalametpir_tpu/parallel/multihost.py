"""Multi-host (multi-process) serving scaffold.

The single-process mesh path (`parallel.sharding`) shards the encoded DB
over the devices one process controls. JAX's multi-controller runtime
extends the exact same program across hosts: every process runs the same
code, `jax.distributed.initialize` wires the coordination service, and
the `Mesh` simply spans all processes' devices — the `psum`s in the hint
and respond kernels then run as collectives across hosts (NCCL on GPU
hosts), with XLA choosing the implementation. The reference has no
multi-node story at all (SURVEY.md section 2: rayon threads + one Vulkan
device), so this subsystem is exceed-parity.

Deployment modes:

* **GPU hosts** — every process calls `initialize()` with the
  coordinator's `host:port`, the process count and its own process id
  (nothing on a plain GPU host tells JAX of a cluster, so all three are
  required), then builds `mesh = make_multihost_mesh(model=
  jax.device_count())` and runs `Server.setup(..., mesh=mesh)` with
  identical inputs on every process.
* **CPU scaffold (tested here)** — N processes with virtual CPU devices
  and explicit coordinator/process ids; cross-process collectives run on
  gloo. `tests/test_multihost.py` drives the full setup+respond protocol
  over two processes this way, which is exactly the program a GPU
  cluster would run (only the collective transport differs).

Determinism contract (same as any SPMD jax program): every process must
call `Server.setup` with byte-identical inputs (db, seed, arity, rng
state) — the encode/filter retry loop must take the same path on every
host. Query bytes originate on one host; `broadcast_query` ships them to
the others before the collective respond.
"""

from __future__ import annotations

import numpy as np

from .sharding import make_mesh


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the multi-controller runtime: pass the coordinator host:port,
    the process count and this process's id (on GPU and CPU hosts JAX
    cannot detect them). Idempotent per process."""
    import jax

    is_init = getattr(jax.distributed, "is_initialized", None)
    if is_init is not None and is_init():
        return
    if coordinator_address is None and not (
        num_processes is None and process_id is None
    ):
        # silently dropping these would fall through to autodetection —
        # on a CPU cluster that means a surprise single-process runtime
        raise ValueError(
            "process_id/num_processes require coordinator_address"
        )
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        # older jax has no is_initialized(); honor the idempotency
        # contract by tolerating a second call
        if "already" not in str(e).lower():
            raise


def make_multihost_mesh(model: int | None = None, data: int = 1):
    """(data, model) mesh over the GLOBAL device set. The default shards
    the DB's fingerprint dimension over every chip of every host
    (data=1): respond psums cross hosts, which is the hard part this
    scaffold exists to prove; a data axis >1 additionally splits query
    batches, but its output gather is host-local only when each data
    group stays within one process."""
    import jax

    return make_mesh(jax.devices(), data=data, model=model)


def warmup_collectives(timeout_s: float = 240.0) -> None:
    """Align every process at a coordination-service barrier, then form
    the global communicator on a trivial psum.

    XLA's gloo rendezvous gives a peer only ~30 s to show up at CONTEXT
    initialization (a hardcoded key-value-get deadline inside the CPU
    collectives); each process reaches its first real collective only
    after independently compiling the whole sharded setup program, and on
    a contended host that skew can exceed the window, failing the run
    with "Gloo context initialization failed: DEADLINE_EXCEEDED". The
    coordination-service barrier has a caller-chosen deadline, so we
    align here and then run a one-element global psum: the communicator
    for the all-devices clique forms while every process is within a
    tiny-compile of the same point, and XLA caches communicators per
    device clique, so every later hint/respond/broadcast collective
    reuses it no matter how far the compile times drift.

    No-op in a single-process runtime."""
    import jax

    if jax.process_count() == 1:
        return
    try:
        # private API (the coordination client has no public barrier);
        # degrade to barrier-less warmup on a jax that moves it — the
        # psum below still forms the communicator, just without the
        # alignment guarantee
        from jax._src import distributed

        client = distributed.global_state.client
    except (ImportError, AttributeError):  # pragma: no cover
        client = None
    if client is not None:
        client.wait_at_barrier(
            "chalametpir_warmup_collectives", timeout_in_ms=int(timeout_s * 1e3)
        )
    from jax.sharding import PartitionSpec as P

    mesh = make_multihost_mesh(model=len(jax.devices()))
    f = jax.jit(
        jax.shard_map(
            lambda x: jax.lax.psum(x, "model"),
            mesh=mesh, in_specs=P("model"), out_specs=P(),
        )
    )
    f(np.ones((len(jax.devices()), 1), np.int32)).block_until_ready()


def _payload_shape(n: int) -> int:
    """Collective payload size for an n-byte query: the next power of two
    (floor 4 KB). Every process derives this from the broadcast header
    alone, so the payload collective's shape agrees everywhere, and the
    log-spaced sizes bound the collective compile cache instead of
    re-jitting per distinct batch length."""
    size = 4096
    while size < n:
        size <<= 1
    return size


def broadcast_query(
    query_bytes: bytes | None, max_len: int = 1 << 26
) -> bytes | None:
    """Ship one host's serialized query to every process (the client talks
    TCP to ONE host; the collective respond needs the bytes everywhere).
    Non-source processes pass None. Uses the jax multihost broadcast
    (gloo/DCN), so no extra transport is needed.

    Two-phase: a tiny fixed-shape header collective carries the byte
    length (or a sentinel), then a payload collective sized from that
    length — so a single-row respond broadcasts kilobytes, not a
    max_batch-deep buffer (with serve-batch sizing that buffer is
    hundreds of MB at realistic fingerprint counts, which made multi-host
    online latency scale with max_batch*m rather than the actual batch).

    An oversized query raises ValueError on EVERY process: the source
    broadcasts a length of -1 instead of bailing before the collective —
    raising pre-collective on one process would leave the peers blocked
    inside broadcast_one_to_all until the distributed timeout.

    Returns None when the source broadcast a shutdown sentinel (see
    broadcast_shutdown) — receivers use this to leave their serving
    loops cleanly."""
    import jax
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        if query_bytes is not None and len(query_bytes) + 8 > max_len:
            raise ValueError("query exceeds broadcast buffer")
        return query_bytes
    header = np.zeros(1, np.int64)
    if query_bytes is not None:
        header[0] = -1 if len(query_bytes) + 8 > max_len else len(query_bytes)
    n = int(np.asarray(multihost_utils.broadcast_one_to_all(header))[0])
    if n == _SHUTDOWN_N:
        return None
    if n < 0:
        raise ValueError("query exceeds broadcast buffer")
    payload = np.zeros(_payload_shape(n), np.uint8)
    if query_bytes is not None:
        payload[:n] = np.frombuffer(query_bytes, np.uint8)
    out = multihost_utils.broadcast_one_to_all(payload)
    return np.asarray(out[:n]).tobytes()


_SHUTDOWN_N = -2


def broadcast_shutdown(max_len: int = 1 << 26) -> None:
    """Leader-side: release every worker blocked in broadcast_query(None)
    (their serving loops return None and exit). Header-only: receivers
    see the sentinel and never enter the payload collective."""
    import jax
    from jax.experimental import multihost_utils

    del max_len  # kept for call-site compatibility; shutdown is header-only
    if jax.process_count() == 1:
        return
    header = np.full(1, _SHUTDOWN_N, np.int64)
    multihost_utils.broadcast_one_to_all(header)


# -- SPMD serving loop --------------------------------------------------------
#
# Multi-host ONLINE serving: the TCP surface lives on the leader
# (process 0); every respond batch is an SPMD collective, so the worker
# processes must execute the same respond_batch with the same queries.
# The leader's batch dispatcher broadcasts each stacked query batch
# (reference wire format, rows = batch size) before running it; workers
# sit in worker_respond_loop doing broadcast -> respond until shutdown.
# Requires a process-local `data` axis (data=1 in practice) so the
# leader can materialise the replicated response.

# The payload collective's shape derives from the broadcast header, so
# batch-size mismatches can no longer desynchronize the collective layer;
# max_batch only caps the oversize check on the SOURCE. Keep leader and
# workers on this constant anyway so the cap they enforce agrees.
DEFAULT_SERVE_BATCH = 64


def _batch_max_len(server, max_batch: int) -> int:
    # length prefix + matrix header + max_batch rows of m u32 columns
    return 16 + 4 * max_batch * server.num_query_cols


def leader_respond_batch_fn(server, max_batch: int = DEFAULT_SERVE_BATCH):
    """Wrap server.respond_batch for the leader's BatchDispatcher: each
    batch is broadcast to the worker processes, then answered by the
    collective respond all processes now run together.

    SPMD failure contract: if the leader's respond raises AFTER its
    batch broadcast, the workers are already inside that batch's
    collective and the process group is desynchronized — continuing to
    serve would issue a MISMATCHED collective (the next batch's header
    broadcast against the workers' stuck respond psum) and wedge the
    transport with no error anywhere. The wrapper therefore poisons
    itself: every later call fails fast, so the serving group dies
    loudly and a supervisor restarts it together (the same contract
    worker_respond_loop documents for a dying worker)."""
    from ..core import matrix_io

    max_len = _batch_max_len(server, max_batch)
    state = {"poisoned": False}

    def respond_batch(rows: np.ndarray) -> np.ndarray:
        if state["poisoned"]:
            raise RuntimeError(
                "multi-host serving poisoned: a collective respond failed "
                "after its batch broadcast; the SPMD processes are "
                "desynchronized — restart the serving group"
            )
        broadcast_query(matrix_io.matrix_to_bytes(rows), max_len=max_len)
        try:
            return server.respond_batch(rows)
        except BaseException:
            state["poisoned"] = True
            raise

    return respond_batch


def worker_respond_loop(server, max_batch: int = DEFAULT_SERVE_BATCH) -> None:
    """Run on every non-leader process: participate in the leader's
    collective responds until it broadcasts shutdown.

    max_batch should equal the leader's dispatcher limit (keep both at
    DEFAULT_SERVE_BATCH) so the oversize cap both sides enforce agrees;
    the payload collective's shape derives from the broadcast header, so
    a mismatch can no longer desynchronize the collective layer itself.
    A worker that dies mid-loop leaves the leader blocked in its next
    broadcast until the distributed-runtime timeout — deploy workers
    under a supervisor that restarts the whole serving group together."""
    from ..core import matrix_io

    max_len = _batch_max_len(server, max_batch)
    while True:
        frame = broadcast_query(None, max_len=max_len)
        if frame is None:
            return
        try:
            server.respond_batch(matrix_io.matrix_from_bytes(frame))
        except BaseException as exc:
            # a worker-side respond failure desynchronizes the SPMD group
            # (the leader is inside this batch's collective): exit LOUDLY
            # so the supervisor restarts the group, instead of silently
            # leaving the loop while the leader keeps serving into a wedge
            import sys

            print(
                f"worker_respond_loop: collective respond failed ({exc!r});"
                " the serving group is desynchronized — restart it together",
                file=sys.stderr, flush=True,
            )
            raise
