"""Device-resident client engine: s . A as int8 products, exact vs host path."""

import numpy as np
import pytest

from chalametpir_tpu import Client, Server
from chalametpir_tpu.core import prg
from chalametpir_tpu.errors import ArithmeticOverflowAddingQueryIndicator
from chalametpir_tpu.ops.client_device import DeviceQueryEngine
from chalametpir_tpu.params import LWE_DIMENSION
from chalametpir_tpu.utils import generate_random_kv_database


@pytest.mark.parametrize("prg_mode", ["stream", "ctr"])
def test_device_engine_matvec_exact(prg_mode, rng):
    m = 300
    seed = rng.bytes(32)
    a = prg.expand_seed(LWE_DIMENSION, m, seed, mode=prg_mode)
    if prg_mode == "ctr":
        eng = DeviceQueryEngine.from_seed_ctr(seed, m)
    else:
        eng = DeviceQueryEngine.from_host_matrix(a)
    codes = rng.integers(0, 3, size=LWE_DIMENSION).astype(np.int8)
    got = eng.matvec(codes)
    pos = a[codes == 1].sum(axis=0, dtype=np.uint64)
    neg = a[codes == 2].sum(axis=0, dtype=np.uint64)
    want = (pos - neg).astype(np.uint32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("prg_mode", ["stream", "ctr"])
def test_device_client_round_trip(prg_mode, rng):
    db = generate_random_kv_database(400, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(
        seed, db, arity=3, backend="numpy", prg_mode=prg_mode, rng=rng
    )
    client = Client.setup(seed, hint, fparams, prg_mode=prg_mode, device=True)
    assert client.uses_device
    keys = list(db.keys())[:4]
    for key in keys:
        while True:
            try:
                q = client.query(key)
                break
            except ArithmeticOverflowAddingQueryIndicator:
                pass
        assert client.process_response(key, server.respond(q)) == db[key]


@pytest.mark.parametrize("device", [False, True])
def test_query_batch_round_trip(device, rng):
    db = generate_random_kv_database(400, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, db, backend="numpy", rng=rng)
    client = Client.setup(seed, hint, fparams, device=device)

    keys = list(db.keys())[:5]
    queries = client.query_batch(keys)
    assert len(queries) == len(keys)
    for key, q in zip(keys, queries):
        assert client.process_response(key, server.respond(q)) == db[key]

    # duplicate keys and already-pending keys are rejected
    from chalametpir_tpu.errors import PendingQueryExistsForKey

    with pytest.raises(PendingQueryExistsForKey):
        client.query_batch([keys[0], keys[0]])
    client.query_batch([keys[0]])  # ok again after processing
    with pytest.raises(PendingQueryExistsForKey):
        client.query_batch([keys[0]])


def test_streaming_engine_matvec_exact(rng):
    """The O(chunk)-memory streaming engine (for m past the device's
    plane budget) matches the host matvec exactly, including a ragged last
    chunk and batches."""
    m = 700  # not a multiple of the step
    seed = rng.bytes(32)
    a = prg.expand_seed(LWE_DIMENSION, m, seed, mode="ctr")
    eng = DeviceQueryEngine.streaming_from_seed_ctr(seed, m, cols_per_step=256)
    codes = rng.integers(0, 3, size=(3, LWE_DIMENSION)).astype(np.int8)
    got = eng.matvec_batch(codes)
    for i in range(3):
        pos = a[codes[i] == 1].sum(axis=0, dtype=np.uint64)
        neg = a[codes[i] == 2].sum(axis=0, dtype=np.uint64)
        assert np.array_equal(got[i], (pos - neg).astype(np.uint32))


def test_streaming_engine_client_round_trip(rng):
    db = generate_random_kv_database(300, rng=rng, value_byte_len=(1, 48))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(
        seed, db, arity=3, backend="numpy", prg_mode="ctr", rng=rng
    )
    client = Client.setup(seed, hint, fparams, prg_mode="ctr", device=False)
    # swap in the streaming engine (auto routes to it only past the
    # 8 GB plane threshold; here we force it on a small DB)
    client._engine = DeviceQueryEngine.streaming_from_seed_ctr(
        seed, client._filter.num_fingerprints, cols_per_step=512
    )
    assert client.uses_device
    client.prepare_queries(2)
    for key in list(db.keys())[:3]:
        while True:
            try:
                q = client.query(key)
                break
            except ArithmeticOverflowAddingQueryIndicator:
                pass
        assert client.process_response(key, server.respond(q)) == db[key]


def test_auto_routes_big_m_to_streaming_engine(rng, monkeypatch):
    """Past the resident-plane device memory budget, auto setup must pick
    the streaming engine instead of trying (and failing) to materialise A.
    The budget comes from the device's memory_stats()."""
    from chalametpir_tpu.ops import backend

    db = generate_random_kv_database(200, rng=rng, value_byte_len=(1, 32))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(
        seed, db, arity=3, backend="numpy", prg_mode="ctr", rng=rng
    )

    calls = {}
    orig = DeviceQueryEngine.streaming_from_seed_ctr.__func__

    def spy(cls, seed, m, cols_per_step=65536):
        calls["streaming_m"] = m
        return orig(cls, seed, m, cols_per_step=512)

    monkeypatch.setattr(
        DeviceQueryEngine, "streaming_from_seed_ctr", classmethod(spy)
    )
    monkeypatch.setattr(backend, "accelerator_present", lambda: True)
    # a device with 1 MB free: far below 4 * m * K_PAD bytes of planes
    monkeypatch.setattr(
        backend, "_memory_stats",
        lambda: {"bytes_limit": 3 << 20, "bytes_in_use": 1 << 20},
    )
    client = Client.setup(seed, hint, fparams, prg_mode="ctr", device="auto")
    assert "streaming_m" in calls and client.uses_device


@pytest.mark.parametrize(
    "stats,want",
    [
        (None, None),
        ({}, None),
        ({"bytes_limit": 1000}, 500),
        ({"bytes_limit": 1000, "bytes_in_use": 200}, 400),
        ({"bytes_limit": 80 << 30, "bytes_in_use": 2 << 30}, 39 << 30),
    ],
)
def test_device_memory_budget_from_memory_stats(stats, want, monkeypatch):
    """Half of the device memory not yet in use; None where the backend
    keeps no statistics (host memory)."""
    from chalametpir_tpu.ops import backend

    monkeypatch.setattr(backend, "_memory_stats", lambda: stats)
    assert backend.device_memory_budget() == want


def test_resident_planes_fit_budget_at_headline_size(monkeypatch, rng):
    """At 2^20 entries the resident planes (about 8.4 GB) stay resident on
    an 80 GB card serving the 1.4 GB packed DB: the budget check routes to
    from_seed_ctr, not the streaming engine."""
    from chalametpir_tpu.core.filter import filter_geometry
    from chalametpir_tpu.ops import backend
    from chalametpir_tpu.ops.client_device import K_PAD

    _, _, m = filter_geometry(3, 1 << 20)
    monkeypatch.setattr(
        backend, "_memory_stats",
        lambda: {"bytes_limit": 60 << 30, "bytes_in_use": 3 << 29},
    )
    assert 4 * m * K_PAD < backend.device_memory_budget()


def test_device_failure_raises_under_auto(rng, monkeypatch):
    """device="auto" on a GPU must not hide a device failure behind the
    host engine: the error reaches the caller."""
    from chalametpir_tpu.ops import backend

    db = generate_random_kv_database(100, rng=rng, value_byte_len=(1, 16))
    seed = rng.bytes(32)
    _, hint, fparams = Server.setup(
        seed, db, arity=3, backend="numpy", prg_mode="ctr", rng=rng
    )

    def boom(cls, seed, m, cols_per_step=32768):
        raise RuntimeError("device out of memory")

    monkeypatch.setattr(backend, "accelerator_present", lambda: True)
    monkeypatch.setattr(DeviceQueryEngine, "from_seed_ctr", classmethod(boom))
    with pytest.raises(RuntimeError, match="out of memory"):
        Client.setup(seed, hint, fparams, prg_mode="ctr", device="auto")
