"""Real-network tier: socket reactor + FlowTransport-equivalent RPC
(ref: fdbrpc/FlowTransport.actor.cpp over flow/Net2.actor.cpp's reactor).

The sim tier (sim/) and this package implement the same
endpoint duck type (`.send(request_with_reply_promise)`), which is the
INetwork seam (flow/network.h:193): role code cannot tell which one it
runs over.
"""

from .reactor import SelectReactor
from .transport import FlowTransport, TransportStream, real_loop_with_transport

__all__ = [
    "SelectReactor",
    "FlowTransport",
    "TransportStream",
    "real_loop_with_transport",
]
