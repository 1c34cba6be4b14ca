"""The port's metrics plane beside its role hosts: MetricLogger
(cluster/metric_logger.py, counters sampled into the database), the
sampling profiler (core/profiler.py) and the system monitor, the HTTP text
exposition (net/http.TextHTTPServer) and the async HTTP client
(net/http.http_request) — the cases of tests/test_metrics.py,
tests/test_layers_and_tools.py, tests/test_profiler_monitor.py and
tests/test_blobstore.py on the port, and MetricLogger's keys and values
byte-equal to the JAX package's."""

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from foundationdb_tpu_torch.core import delay
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
from foundationdb_tpu_torch.core.metrics import MetricRegistry, global_registry
from foundationdb_tpu_torch.core.profiler import Profiler
from foundationdb_tpu_torch.core.runtime import loop_context, sim_loop
from foundationdb_tpu_torch.core.stats import Counter
from foundationdb_tpu_torch.core.system_monitor import SystemMonitor

from _torch_mp import JAX, PORT, mod
from test_metrics import _PROM_COMMENT, _PROM_SAMPLE


@pytest.fixture()
def psim():
    """A fresh deterministic loop of the port, made current."""
    loop = sim_loop(seed=12345)
    with loop_context(loop):
        yield loop
    loop.shutdown()


# ------------------------------------------------------------ MetricLogger

def test_metric_logger_registry_mode_and_retention(psim):
    from foundationdb_tpu_torch.cluster.cluster import LocalCluster
    from foundationdb_tpu_torch.cluster.metric_logger import (
        MetricLogger,
        read_series,
    )

    old = SERVER_KNOBS.METRICS_RETENTION_SECONDS
    SERVER_KNOBS.METRICS_RETENTION_SECONDS = 5.0
    try:
        async def main():
            c = LocalCluster(device="cpu").start()
            db = c.database()
            ml = MetricLogger(db, interval=1.0,
                              registry=global_registry())
            ml.start()
            for i in range(15):
                await db.set(b"r%d" % (i % 4), b"v")
                await delay(1.0)
            await delay(1.5)
            series = await read_series(db, "registry",
                                       "proxy.txns_committed")
            assert len(series) >= 2
            buckets = [s[0] for s in series]
            totals = [s[1] for s in series]
            assert buckets == sorted(buckets)
            assert totals == sorted(totals) and totals[-1] >= 15
            # retention: the oldest bucket within the knob's horizon
            assert buckets[-1] - buckets[0] <= 5 + 1
            bounded = await read_series(
                db, "registry", "proxy.txns_committed",
                min_bucket=buckets[0], max_bucket=buckets[-1],
            )
            assert [s[0] for s in bounded] == buckets[:-1]
            capped = await read_series(db, "registry",
                                       "proxy.txns_committed", limit=2)
            assert len(capped) == 2 and capped[0][0] == buckets[0]
            ml.stop()
            c.stop()

        psim.run(main())
    finally:
        SERVER_KNOBS.METRICS_RETENTION_SECONDS = old


def test_metric_logger_time_series_in_db(psim):
    """Counters sampled INTO the database itself (ref: TDMetric +
    MetricLogger)."""
    from foundationdb_tpu_torch.cluster.cluster import LocalCluster
    from foundationdb_tpu_torch.cluster.metric_logger import (
        MetricLogger,
        read_series,
    )

    async def main():
        c = LocalCluster(device="cpu").start()
        db = c.database()
        ml = MetricLogger(db, interval=0.5)
        ml.register(c.proxy.stats)
        ml.start()
        for i in range(10):
            await db.set(b"k%d" % i, b"v")
            await delay(0.2)
        await delay(1.0)
        series = await read_series(db, "ProxyStats", "TxnsCommitted")
        assert len(series) >= 3
        buckets = [s[0] for s in series]
        totals = [s[1] for s in series]
        assert buckets == sorted(buckets)
        assert totals == sorted(totals) and totals[-1] >= 10
        assert any(rate > 0 for _, _, rate in series)
        ml.stop()
        c.stop()

    psim.run(main())


@pytest.mark.parametrize("collection,counter,bucket,total,rate", [
    ("ProxyStats", "TxnsCommitted", 0, 0, 0.0),
    ("registry", "proxy.txns_committed", 1234, 99, 12.5),
    ("registry", "storage.bytes_input", 2**40, -3, -0.25),
])
def test_metric_logger_rows_equal_the_jax_package(collection, counter,
                                                  bucket, total, rate):
    """The \\xff/metrics/ keys and values (the tuple layer) are the JAX
    package's bytes."""
    port = mod(PORT, "cluster.metric_logger")
    ref = mod(JAX, "cluster.metric_logger")
    assert port._key(collection, counter, bucket) == \
        ref._key(collection, counter, bucket)
    assert port._value(total, rate) == ref._value(total, rate)


# ------------------------------------------------ profiler, system monitor

def _burn(n: int) -> int:
    total = 0
    for i in range(n):
        total += i * i % 7
    return total


def test_profiler_samples_hot_function():
    p = Profiler()
    p.start(interval=0.001)
    try:
        _burn(3_000_000)
    finally:
        p.stop()
    assert p.total_samples > 0
    top = p.top_frames(5)
    assert top, "no hotspots recorded"
    assert any("_burn" in frame for frame, _ in top), top
    p.dump()  # must not raise


def test_profiler_stop_is_idempotent():
    p = Profiler()
    p.start(interval=0.01)
    p.stop()
    p.stop()


def test_system_monitor_emits_metrics(psim):
    from foundationdb_tpu_torch.core.trace import global_sink

    async def main():
        mon = SystemMonitor(interval=1.0).start()
        await delay(3.5)
        mon.stop()

    psim.run(main())
    events = global_sink().find("ProcessMetrics")
    assert len(events) >= 3
    ev = events[-1]
    assert "UserCPUSeconds" in ev and "LoopTasksRun" in ev


# --------------------------------------------------------------- HTTP tier

def test_metrics_http_server_serves_parseable_exposition():
    from foundationdb_tpu_torch.net.http import TextHTTPServer, http_request
    from foundationdb_tpu_torch.net.transport import real_loop_with_transport

    loop, transport = real_loop_with_transport()
    with loop_context(loop):
        reg = MetricRegistry()
        c = Counter("x")
        c.add(9)
        reg.register_counter("demo.txns_committed", c)
        reg.register_gauge("demo.queue_bytes", lambda: 55)
        srv = TextHTTPServer(
            0, reg.prometheus_text,
            content_type="text/plain; version=0.0.4",
        ).start()
        assert srv.port > 0

        async def main():
            return await http_request("127.0.0.1", srv.port, "GET",
                                      "/metrics")

        resp = loop.run(main(), timeout_sim_seconds=30)
        srv.stop()
        transport.close()
    assert resp.status == 200
    assert resp.headers["content-type"].startswith("text/plain")
    body = resp.body.decode()
    for line in body.strip().splitlines():
        if line.startswith("#"):
            assert _PROM_COMMENT.match(line), line
        else:
            assert _PROM_SAMPLE.match(line), line
    assert "fdbtpu_demo_txns_committed 9" in body
    assert "fdbtpu_demo_queue_bytes 55" in body


class _StoreHandler(BaseHTTPRequestHandler):
    """A tiny object store: GET (404 when absent) and PUT."""

    store: dict = {}

    def do_GET(self):
        body = self.store.get(self.path)
        self.send_response(404 if body is None else 200)
        self.send_header("Content-Length", str(len(body or b"")))
        self.end_headers()
        self.wfile.write(body or b"")

    def do_PUT(self):
        n = int(self.headers.get("Content-Length", 0))
        self.store[self.path] = self.rfile.read(n)
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.fixture()
def store_server():
    _StoreHandler.store = {}
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _StoreHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address[1]
    srv.shutdown()
    t.join(timeout=10)


def test_async_http_client(store_server):
    """404, then PUT, then GET round trip through the async client on a
    real-clock loop, and the blocking twin reads the same object."""
    from foundationdb_tpu_torch.net.http import (
        http_request,
        http_request_sync,
    )
    from foundationdb_tpu_torch.net.transport import real_loop_with_transport

    loop, transport = real_loop_with_transport()
    with loop_context(loop):
        async def main():
            r = await http_request("127.0.0.1", store_server, "GET",
                                   "/b/miss")
            assert r.status == 404
            r = await http_request("127.0.0.1", store_server, "PUT", "/b/x",
                                   headers={"X-Test": "1"}, body=b"hello")
            assert r.status == 200
            r = await http_request("127.0.0.1", store_server, "GET", "/b/x")
            assert r.status == 200 and r.body == b"hello"
            return True

        assert loop.run(main(), timeout_sim_seconds=30)
        transport.close()
    r = http_request_sync("127.0.0.1", store_server, "GET", "/b/x")
    assert r.status == 200 and r.body == b"hello"
