"""TLS contexts for the transport (ref: FDBLibTLS/ + fdbrpc/
TLSConnection.actor.cpp — a plugin builds policy-bearing contexts; the
transport wraps any connection with them).

The reference's plugin exposes cert/key/CA configuration plus a peer
verification DSL; this module builds the ssl.SSLContext pair the
FlowTransport accepts (`tls_server=`/`tls_client=`). Mutual auth is on by
default, as in the reference (every fdbserver both serves and dials).
"""

from __future__ import annotations

import ssl
from typing import Optional


def server_context(cert_path: str, key_path: str,
                   ca_path: Optional[str] = None,
                   require_client_cert: bool = True) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    if ca_path is not None:
        ctx.load_verify_locations(ca_path)
        if require_client_cert:
            ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_context(cert_path: Optional[str] = None,
                   key_path: Optional[str] = None,
                   ca_path: Optional[str] = None,
                   verify_hostname: bool = False) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    # Cluster certs are operator-issued; hostname checks are off by
    # default exactly like the reference's verify_peers default.
    ctx.check_hostname = verify_hostname
    if ca_path is not None:
        ctx.load_verify_locations(ca_path)
    else:
        ctx.verify_mode = ssl.CERT_NONE
    if cert_path is not None and key_path is not None:
        ctx.load_cert_chain(cert_path, key_path)
    return ctx
