"""asyncio TCP PIR client (reference: chalametpir_client/examples/client.rs).

Run: python -m chalametpir_tpu.net.client --key banana [--host ... --port ...]

The client keeps A on the host by default (`--device host`): a JAX
process reserves most of a GPU's memory when it first uses it, so a
client started beside a server on the same card would fail for want of
memory. `--device gpu` runs s . A on the GPU, for a client with a card
of its own.
"""

from __future__ import annotations

import argparse
import asyncio
import sys

from ..errors import (
    ArithmeticOverflowAddingQueryIndicator,
    PendingQueryExistsForKey,
)
from ..models.client import Client
from ..params import SEED_BYTE_LEN
from .framing import read_frame, write_frame


def _query_or_none(client: Client, key: bytes) -> bytes | None:
    """One key's query with the overflow retry; a PendingQueryExistsForKey
    (repeated key, or a key whose earlier malformed response kept its
    pending entry) is reported per-key instead of aborting the whole
    fetch."""
    while True:
        try:
            return client.query(key)
        except ArithmeticOverflowAddingQueryIndicator:
            continue
        except PendingQueryExistsForKey as exc:
            print(f"Skipping {key!r}: {exc}", file=sys.stderr)
            return None


async def fetch(
    host: str, port: int, keys: list[bytes], prg_mode: str = "stream",
    device: bool | str = False, pool: int = 0,
) -> dict[bytes, bytes | None]:
    """Fetch `keys` from a PIR server. `device` is Client.setup's (False
    keeps A on the host). pool > 0 runs FrodoPIR's offline
    query preprocessing for that many queries right after setup (one
    batched matvec), so the per-key online latency drops to the pooled
    path (~ms instead of one s.A matvec per key)."""
    reader, writer = await asyncio.open_connection(host, port)
    print(f"Connected to PIR server @ {host}:{port}", file=sys.stderr)

    seed = await reader.readexactly(SEED_BYTE_LEN)
    # bound what a hostile/buggy server can make us buffer: the hint is
    # 1774 x cols x 4 B (single-digit MB for any sane value length; 1 GiB
    # is far beyond every supported config), the filter params are 68 B
    hint = await read_frame(reader, max_len=1 << 30)
    filter_params = await read_frame(reader, max_len=4096)
    print(f"Received setup data ({len(hint)} B hint)", file=sys.stderr)

    client = Client.setup(
        seed, hint, filter_params, prg_mode=prg_mode, device=device,
        prepared_queries=min(pool, len(keys)) if pool else 0,
    )
    # a valid response is exactly (1, cols) u32 + the 8-byte header
    max_response_frame = client._hint_mat_m.shape[1] * 4 + 64
    results: dict[bytes, bytes | None] = {}
    try:
        for key in keys:
            query = _query_or_none(client, key)
            if query is None:
                results.setdefault(key, None)
                continue
            try:
                write_frame(writer, query)
                await writer.drain()
                response = await read_frame(reader, max_response_frame)
            except (asyncio.IncompleteReadError, ConnectionError,
                    ValueError) as exc:
                # ConnectionError covers reset/aborted/broken-pipe alike
                # transport death (server drop, network blip, oversized
                # frame): the connection is gone, so the remaining keys
                # can't succeed — mark them failed and return the values
                # already retrieved instead of discarding them with a
                # traceback (same per-key isolation as the decode path)
                print(f"Connection lost fetching {key!r}: {exc!r}",
                      file=sys.stderr)
                for k in keys:
                    results.setdefault(k, None)
                break
            try:
                results[key] = client.process_response(key, response)
            except Exception as exc:  # noqa: BLE001 - report per-key failure
                print(f"Failed to retrieve {key!r}: {exc}", file=sys.stderr)
                results[key] = None
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionError:
            pass
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--key", action="append", default=[], help="key to fetch (repeatable)")
    ap.add_argument("--prg-mode", default="stream", choices=("stream", "ctr"),
                    help="must match the server's --prg-mode")
    ap.add_argument("--pool", type=int, default=0, metavar="N",
                    help="precompute N query pairs after setup (FrodoPIR "
                         "offline phase); online per-key latency drops to ~ms")
    ap.add_argument("--device", default="host", choices=("host", "gpu"),
                    help="where A lives and s . A runs (default host: a "
                         "server on the same card keeps its memory)")
    args = ap.parse_args(argv)
    keys = [k.encode() for k in args.key] or [b"banana"]

    results = asyncio.run(
        fetch(args.host, args.port, keys, prg_mode=args.prg_mode,
              device=args.device == "gpu", pool=args.pool)
    )
    for key, value in results.items():
        if value is None:
            print(f"{key.decode(errors='replace')}: <failed>")
        else:
            print(f"{key.decode(errors='replace')}: {value.decode(errors='replace')}")


if __name__ == "__main__":
    main()
