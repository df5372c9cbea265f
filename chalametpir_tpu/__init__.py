"""chalametpir_tpu — a GPU framework for single-server keyword
Private Information Retrieval (ChalametPIR: FrodoPIR + binary fuse filters).

Public API mirrors the reference crates' surface
(reference: chalametpir_server/src/lib.rs:75-81,
chalametpir_client/src/lib.rs:62-65, chalametpir_common/src/lib.rs:1-7):

    from chalametpir_tpu import Server, Client
    server, hint, filter_params = Server.setup(seed, db, arity=3)
    client = Client.setup(seed, hint, filter_params)
    query = client.query(b"key")
    response = server.respond(query)
    value = client.process_response(b"key", response)
"""

from .errors import ChalametPIRError
from .params import SEED_BYTE_LEN, LWE_DIMENSION
from .core.filter import BinaryFuseFilter
from .models.server import Server
from .models.client import Client, Query

__all__ = [
    "Server",
    "Client",
    "Query",
    "BinaryFuseFilter",
    "ChalametPIRError",
    "SEED_BYTE_LEN",
    "LWE_DIMENSION",
]

__version__ = "0.2.0"
