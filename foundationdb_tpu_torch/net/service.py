"""Serving a cluster over the real transport (ref: the well-known
endpoint tokens FlowTransport reserves for bootstrap interfaces,
fdbrpc/FlowTransport.h:109 WLTOKEN_*).

`serve_cluster` registers a cluster's GRV/commit/read endpoints under
fixed tokens so any wire client (the Python transport, the C client in
native/fdb_c_client.cpp) can reach them knowing only host:port.

The port's copy of foundationdb_tpu/net/service.py: the served
LocalCluster's conflict set and storage window run on `device` (None: the
CUDA card, which must be present; "cpu" runs their plain torch
versions)."""

from __future__ import annotations

# Well-known service tokens (stable ABI shared with native/fdb_c_client.cpp).
WLTOKEN_GRV = 10
WLTOKEN_COMMIT = 11
WLTOKEN_READ = 12


def serve_cluster(transport, cluster) -> None:
    transport.register_endpoint(cluster.proxy.grv_stream, WLTOKEN_GRV)
    transport.register_endpoint(cluster.proxy.commit_stream, WLTOKEN_COMMIT)
    transport.register_endpoint(cluster.storage.read_stream, WLTOKEN_READ)


def run_network_server(port: int = 0, ready=None, stop_event=None,
                       device=None):
    """Run a LocalCluster served over TCP on a real-clock loop — the
    embedded `fdbd` of the wire tier. Blocks until `stop_event` (a
    threading.Event) is set; `ready` (threading.Event) fires with
    `.address` set once listening. Intended for a dedicated thread. The
    cluster's device backends run on `device` (None: the CUDA card)."""
    from ..cluster.cluster import LocalCluster
    from ..core.runtime import EventLoop, loop_context
    from .reactor import SelectReactor
    from .transport import FlowTransport

    loop = EventLoop()
    loop.reactor = SelectReactor()
    with loop_context(loop):
        transport = FlowTransport(loop.reactor, port=port)
        cluster = LocalCluster(device=device).start()
        serve_cluster(transport, cluster)
        if ready is not None:
            ready.address = transport.local_address
            ready.set()

        async def serve():
            from ..core.runtime import current_loop

            while stop_event is None or not stop_event.is_set():
                await current_loop().delay(0.05)

        loop.run(serve())
        cluster.stop()
        transport.close()
