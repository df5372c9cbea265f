"""Multi-host scaffold: the sharded protocol across PROCESS boundaries.

The in-process 8-device mesh tier (test_sharding.py, dryrun_multichip)
proves the collective structure; this tier proves the multi-controller
runtime story: two separate processes, each owning 4 virtual CPU
devices, join via jax.distributed, build one global (1, 8) mesh, run the
sharded ctr setup (hint psums cross the process boundary over gloo —
across GPU hosts the identical program reduces over NCCL), broadcast a
client query from process 0, and answer it with a collective respond.
The reference has no multi-node capability at all (SURVEY.md section 2),
so this is exceed-parity surface.
"""

import os
import signal
import socket
import subprocess
import sys

import pytest


def test_broadcast_query_single_process_contract():
    """The single-process fast path: bytes pass through unchanged and an
    oversized query raises the same ValueError the multi-process sentinel
    path raises on every peer."""
    from chalametpir_tpu.parallel import multihost

    payload = b"\x01\x02\x03" * 11
    assert multihost.broadcast_query(payload, max_len=64) == payload
    with pytest.raises(ValueError):
        multihost.broadcast_query(b"x" * 57, max_len=64)


def test_payload_shape_is_header_derived():
    """Every process derives the payload collective's shape from the
    broadcast header alone — log-spaced so tiny batches broadcast KBs
    (not a max_batch-deep buffer) while the compile cache stays bounded."""
    from chalametpir_tpu.parallel.multihost import _payload_shape

    assert _payload_shape(0) == 4096
    assert _payload_shape(4096) == 4096
    assert _payload_shape(4097) == 8192
    assert _payload_shape(1 << 20) == 1 << 20
    assert _payload_shape((1 << 20) + 1) == 1 << 21


def test_leader_respond_poisons_after_broadcast_failure(rng):
    """SPMD failure contract: a respond failing AFTER its batch broadcast
    leaves the workers inside that batch's collective — continuing to
    serve would issue a mismatched collective and wedge the transport
    silently. The wrapper must re-raise the original error once, then
    fail fast on every later call (single-process drive: broadcast_query
    passes through, so the contract is testable without a cluster)."""
    import numpy as np

    from chalametpir_tpu.models.server import Server
    from chalametpir_tpu.net.server import DEMO_DB
    from chalametpir_tpu.parallel import multihost

    seed = rng.bytes(32)
    server, _, _ = Server.setup(seed, DEMO_DB, backend="numpy", rng=rng)
    boom = {"on": True}
    orig = server.respond_batch

    def flaky(rows):
        if boom["on"]:
            raise RuntimeError("transient device failure")
        return orig(rows)

    server.respond_batch = flaky
    fn = multihost.leader_respond_batch_fn(server, max_batch=4)
    rows = np.zeros((1, server.num_query_cols), np.uint32)
    with pytest.raises(RuntimeError, match="transient device failure"):
        fn(rows)
    boom["on"] = False  # even a now-healthy respond must NOT run again
    with pytest.raises(RuntimeError, match="poisoned"):
        fn(rows)


def test_warmup_collectives_single_process_noop():
    """In a single-process runtime there is no cross-process communicator
    to form: warmup must return immediately without touching the
    coordination service (which does not exist here)."""
    from chalametpir_tpu.parallel import multihost

    multihost.warmup_collectives(timeout_s=1.0)


def test_initialize_rejects_partial_cluster_spec():
    """process_id/num_processes without a coordinator address must raise,
    not silently fall through to autodetection."""
    from chalametpir_tpu.parallel import multihost

    with pytest.raises(ValueError):
        multihost.initialize(process_id=0)
    with pytest.raises(ValueError):
        multihost.initialize(num_processes=2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_round_trip():
    port = _free_port()
    # own session + process-group kill: the workers inherit the captured
    # pipes, so killing only the launcher would leave communicate()
    # blocked on a wedged grandchild holding the write end open
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "chalametpir_tpu.parallel.multihost_demo",
            "--launch", "2", "--coordinator", f"127.0.0.1:{port}",
            "--entries", "300", "--timeout", "420",
        ],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    try:
        # generous: ~45 s on a quiet host, but a contended host can run
        # several times slower, and two processes compiling the sharded
        # program time-share its cores
        out, err = proc.communicate(timeout=460)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"multihost demo timed out:\n{(out + err)[-3000:]}")
    combined = out + err
    assert proc.returncode == 0, f"multihost demo failed:\n{combined[-3000:]}"
    assert "MULTIHOST OK" in combined, f"no MULTIHOST OK in:\n{combined[-3000:]}"


def test_two_process_tcp_serving_round_trip(tmp_path):
    """Online serving across processes: the leader's TCP surface answers
    an EXTERNAL client while every respond batch runs as an SPMD
    collective with the worker process, then shuts the workers down
    cleanly. This is the full production composition: reference-framed
    TCP in front, cross-process psum behind."""
    import asyncio
    import time

    import numpy as np

    port_file = str(tmp_path / "port")
    port_coord = _free_port()
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "chalametpir_tpu.parallel.multihost_demo",
            "--launch", "2", "--coordinator", f"127.0.0.1:{port_coord}",
            "--entries", "300", "--timeout", "420",
            "--tcp-queries", "2", "--port-file", port_file,
        ],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    try:
        deadline = time.time() + 400
        port = None
        while time.time() < deadline and proc.poll() is None:
            if os.path.exists(port_file):
                port = int(open(port_file).read())
                break
            time.sleep(0.25)
        assert port, "leader never published its TCP port"

        from chalametpir_tpu.net.client import fetch
        from chalametpir_tpu.utils import generate_random_kv_database

        # same deterministic DB the demo builds (SPMD contract)
        db = generate_random_kv_database(
            300, rng=np.random.default_rng(0xD157), value_byte_len=(1, 64)
        )
        keys = sorted(db)[:2]
        results = asyncio.run(fetch("127.0.0.1", port, keys, prg_mode="ctr"))
        for k in keys:
            assert results[k] == db[k]
        out, err = proc.communicate(timeout=180)
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    combined = out + err
    assert proc.returncode == 0, f"demo failed:\n{combined[-3000:]}"
    assert "MULTIHOST TCP OK" in combined
