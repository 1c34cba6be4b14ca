"""MetricRegistry: the per-process metrics plane (ref: flow/Stats.h
Counter/CounterCollection + flow/TDMetric.actor.h — the reference keeps
every role's counters behind one continuously-flushed registry and
multi-resolution time series queryable from the cluster itself).

One registry per event loop (== per process on the real tier, per sim
run under simulation) unifies the repo's instrument zoo behind a single
registration API with stable dotted names + label sets:

    reg = global_registry()
    reg.register_counter("proxy.txns_committed", counter)
    reg.register_gauge("tlog.queue_bytes", lambda: qbytes())
    reg.register_bands("proxy.commit_ms", latency_bands)
    reg.register_sample("resolver.stage_ms", sample, labels=(("stage", "pack"),))
    reg.register_smoother("ratekeeper.smoothed_lag_versions", smoother)

Naming contract (enforced at registration — a bad name is a STARTUP
error, and fdblint's `metric-name-format` catches literals statically):
names are snake_case dotted paths (at least two segments); every
non-counter instrument's last name token is a unit suffix from
UNIT_SUFFIXES, so a scraper can always tell bytes from versions from
milliseconds. Registering a second live instrument under the same
(name, labels) raises unless `replace=True` — the recovery idiom: a
recruited generation's role supersedes its predecessor's instruments.

Snapshots are DETERMINISTIC under simulation: entries are emitted in
sorted (name, labels) order and every value derives from loop-seeded
state (counters, reservoirs, sim time) — the same seed produces a
bit-identical snapshot. Wall-clock-fed instruments (process RSS, CPU)
register with `volatile=True` and are excluded from
`snapshot(volatile=False)`, the form the determinism contract covers.

The registry also keeps TDMetric-style ring-buffer TIME SERIES: a
sampler actor records every numeric instrument at two resolutions
(fine = every METRICS_SAMPLE_INTERVAL, coarse = every
METRICS_SERIES_COARSE_FACTOR-th tick), knob-bounded in length, so a
scrape can return recent history without a historian process.
"""

from __future__ import annotations

import re
from collections import deque
from fnmatch import fnmatchcase
from typing import Any, Callable, Optional

from .runtime import Task, current_loop, spawn

# Unit suffixes a non-counter metric name must end with (its last
# `_`-separated token). Kept in sync with tools/fdblint/rules_metrics.py
# (asserted by tests/test_metrics.py::test_lint_unit_suffixes_in_sync).
UNIT_SUFFIXES = (
    "ms", "seconds", "bytes", "versions", "version", "count", "total",
    "depth", "tps", "keys", "entries", "fds", "ratio",
)

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")


class MetricError(ValueError):
    """Bad metric name or duplicate registration — raised AT REGISTRATION
    (role/host construction), so a malformed metrics plane fails the
    process at startup instead of serving a half-broken scrape."""


def validate_name(name: str, kind: str) -> None:
    if not _NAME_RE.match(name):
        raise MetricError(
            f"metric name {name!r} is not a snake_case dotted path "
            "(expected e.g. 'proxy.txns_committed')"
        )
    if kind != "counter":
        last = name.rsplit(".", 1)[-1].rsplit("_", 1)[-1]
        if last not in UNIT_SUFFIXES:
            raise MetricError(
                f"{kind} metric {name!r} lacks a unit suffix: the last "
                f"name token must be one of {', '.join(UNIT_SUFFIXES)}"
            )


def _norm_labels(labels) -> tuple:
    if not labels:
        return ()
    if isinstance(labels, dict):
        labels = labels.items()
    out = tuple(sorted((str(k), str(v)) for k, v in labels))
    return out


class _Metric:
    __slots__ = ("name", "kind", "labels", "read", "volatile", "help",
                 "fine", "coarse")

    def __init__(self, name: str, kind: str, labels: tuple,
                 read: Callable[[], Any], volatile: bool, help_: str,
                 series_len: int):
        self.name = name
        self.kind = kind
        self.labels = labels
        self.read = read
        self.volatile = volatile
        self.help = help_
        # Ring-buffer series (numeric kinds only): (t, value) pairs at
        # two resolutions, bounded by the knob-sized maxlen.
        self.fine: deque = deque(maxlen=series_len)
        self.coarse: deque = deque(maxlen=series_len)

    def numeric(self) -> Optional[float]:
        """The instrument's scalar for the time-series rings (None for
        shapes with no single scalar)."""
        v = self.read()
        if isinstance(v, bool):
            return float(v)
        if isinstance(v, (int, float)):
            return v
        if isinstance(v, dict):
            if "total" in v and isinstance(v["total"], (int, float)):
                return v["total"]
        return None


class MetricRegistry:
    def __init__(self):
        self._metrics: dict[tuple[str, tuple], _Metric] = {}
        self._sampler: Optional[Task] = None
        self._ticks = 0

    # -- registration ----------------------------------------------------
    def _series_len(self) -> int:
        from .knobs import SERVER_KNOBS

        return SERVER_KNOBS.METRICS_SERIES_SAMPLES

    def _register(self, name: str, kind: str, read, labels=(),
                  volatile: bool = False, replace: bool = False,
                  help_: str = "") -> _Metric:
        validate_name(name, kind)
        labels = _norm_labels(labels)
        key = (name, labels)
        if key in self._metrics and not replace:
            raise MetricError(
                f"metric {name!r} labels={dict(labels)} already "
                "registered (a recruited successor role passes "
                "replace=True; anything else is a name collision)"
            )
        for (other_name, _), other in self._metrics.items():
            if other_name == name and other.kind != kind:
                # One exposition TYPE per name: a gauge and a counter
                # sharing a name would lie to every scraper.
                raise MetricError(
                    f"metric {name!r} already registered as "
                    f"{other.kind}; cannot re-register as {kind}"
                )
        m = _Metric(name, kind, labels, read, volatile, help_,
                    self._series_len())
        self._metrics[key] = m
        return m

    def register_counter(self, name: str, counter, labels=(),
                         replace: bool = False, help: str = ""):
        """A core/stats.Counter (or any object with a numeric `.total`)."""
        return self._register(name, "counter", lambda: counter.total,
                              labels, False, replace, help)

    def register_gauge(self, name: str, fn: Callable[[], Any], labels=(),
                       volatile: bool = False, replace: bool = False,
                       help: str = ""):
        """A zero-arg callback read at snapshot time. `volatile=True`
        marks wall-clock-fed gauges (process RSS/CPU) that the
        determinism-covered snapshot form excludes."""
        return self._register(name, "gauge", fn, labels, volatile,
                              replace, help)

    def register_sample(self, name: str, sample, labels=(),
                        replace: bool = False, help: str = ""):
        """A core/stats.ContinuousSample reservoir → p50/p99/population."""
        def read():
            p50 = sample.percentile(0.5)
            p99 = sample.percentile(0.99)
            return {
                "p50": round(p50, 4) if p50 is not None else None,
                "p99": round(p99, 4) if p99 is not None else None,
                "samples": sample.population,
            }

        return self._register(name, "sample", read, labels, False,
                              replace, help)

    def register_bands(self, name: str, bands, labels=(),
                       replace: bool = False, help: str = ""):
        """A core/stats.LatencyBands histogram (cumulative buckets +
        per-band exemplar debug IDs)."""
        return self._register(name, "bands", bands.status, labels, False,
                              replace, help)

    def register_smoother(self, name: str, smoother, labels=(),
                          replace: bool = False, help: str = ""):
        """A core/stats.Smoother → its smoothed total (loop-time-driven,
        so deterministic under sim)."""
        return self._register(
            name, "smoother", lambda: round(smoother.smooth_total(), 6),
            labels, False, replace, help,
        )

    def unregister(self, name: str, labels=()) -> bool:
        return self._metrics.pop((name, _norm_labels(labels)), None) is not None

    def __contains__(self, name: str) -> bool:
        return any(k[0] == name for k in self._metrics)

    def names(self) -> list[str]:
        return sorted({k[0] for k in self._metrics})

    # -- snapshots -------------------------------------------------------
    def snapshot(self, volatile: bool = True, pattern: str = "",
                 series: bool = False) -> list[dict]:
        """Sorted, deterministic list of every metric's current value.
        `volatile=False` excludes wall-clock-fed instruments (the form
        the same-seed bit-identity contract covers); `pattern` is an
        fnmatch glob over names; `series=True` attaches the ring-buffer
        history."""
        out = []
        for key in sorted(self._metrics):
            m = self._metrics[key]
            if m.volatile and not volatile:
                continue
            if pattern and not fnmatchcase(m.name, pattern):
                continue
            entry: dict[str, Any] = {
                "name": m.name,
                "labels": dict(m.labels),
                "kind": m.kind,
                "value": m.read(),
            }
            if series:
                entry["series"] = {"fine": list(m.fine),
                                   "coarse": list(m.coarse)}
            out.append(entry)
        return out

    def status_block(self) -> dict:
        """The `metrics` block of status json: a summary, not the full
        dump (scrapes pull the dump over MetricsRequest / HTTP)."""
        kinds: dict[str, int] = {}
        for key in sorted(self._metrics):
            k = self._metrics[key].kind
            kinds[k] = kinds.get(k, 0) + 1
        return {
            "registered_count": len(self._metrics),
            "kinds": kinds,
            "series_ticks": self._ticks,
        }

    # -- ring-buffer time series ----------------------------------------
    def record_tick(self) -> None:
        """Record one sample of every numeric instrument into the fine
        ring (and every COARSE_FACTOR-th tick into the coarse ring)."""
        from .knobs import SERVER_KNOBS

        now = round(current_loop().now(), 6)
        coarse = self._ticks % SERVER_KNOBS.METRICS_SERIES_COARSE_FACTOR == 0
        self._ticks += 1
        for key in sorted(self._metrics):
            m = self._metrics[key]
            v = m.numeric()
            if v is None:
                continue
            m.fine.append((now, v))
            if coarse:
                m.coarse.append((now, v))

    def start_sampler(self) -> Task:
        """The per-process series sampler (rides the loop's timers, so it
        is seed-deterministic under sim). Idempotent: one sampler per
        registry, however many roles ask."""
        from .knobs import SERVER_KNOBS

        if self._sampler is not None and not self._sampler.done.is_set():
            return self._sampler

        async def run():
            loop = current_loop()
            while True:
                await loop.delay(SERVER_KNOBS.METRICS_SAMPLE_INTERVAL)
                self.record_tick()

        self._sampler = spawn(run(), name="metricsSampler")
        return self._sampler

    def stop_sampler(self) -> None:
        if self._sampler is not None:
            self._sampler.cancel()
            self._sampler = None

    # -- Prometheus text exposition -------------------------------------
    def prometheus_text(self, prefix: str = "fdbtpu") -> str:
        """The classic text exposition format (one HELP/TYPE header per
        name, cumulative `_bucket{le=...}` lines for bands, quantile
        lines for samples) — what `--metrics-port` serves."""
        by_name: dict[str, list[_Metric]] = {}
        for key in sorted(self._metrics):
            m = self._metrics[key]
            by_name.setdefault(m.name, []).append(m)
        lines: list[str] = []
        for name in sorted(by_name):
            ms = by_name[name]
            pname = f"{prefix}_{name.replace('.', '_')}"
            kind = ms[0].kind
            ptype = {"counter": "counter", "gauge": "gauge",
                     "smoother": "gauge", "sample": "summary",
                     "bands": "histogram"}[kind]
            help_ = ms[0].help or f"{kind} {name}"
            lines.append(f"# HELP {pname} {_esc_help(help_)}")
            lines.append(f"# TYPE {pname} {ptype}")
            for m in ms:
                lines.extend(_expo_lines(pname, m))
        return "\n".join(lines) + "\n"


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: tuple, extra: tuple = ()) -> str:
    items = tuple(labels) + tuple(extra)
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in items
    )
    return "{" + body + "}"


def _fmt_value(v) -> str:
    if v is None:
        return "NaN"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, int):
        return str(v)
    return "NaN"


def _expo_lines(pname: str, m: _Metric) -> list[str]:
    v = m.read()
    if m.kind in ("counter", "gauge", "smoother"):
        if not isinstance(v, (int, float)):
            return []
        return [f"{pname}{_fmt_labels(m.labels)} {_fmt_value(v)}"]
    if m.kind == "sample":
        out = []
        for q, key in (("0.5", "p50"), ("0.99", "p99")):
            out.append(
                f"{pname}{_fmt_labels(m.labels, (('quantile', q),))} "
                f"{_fmt_value(v.get(key))}"
            )
        out.append(f"{pname}_count{_fmt_labels(m.labels)} "
                   f"{_fmt_value(v.get('samples'))}")
        return out
    if m.kind == "bands":
        out = []
        for edge, acc in v.get("bands_ms", {}).items():
            le = "+Inf" if edge == "inf" else edge
            out.append(
                f"{pname}_bucket{_fmt_labels(m.labels, (('le', le),))} "
                f"{_fmt_value(acc)}"
            )
        out.append(f"{pname}_count{_fmt_labels(m.labels)} "
                   f"{_fmt_value(v.get('total'))}")
        return out
    return []


# -- the per-loop (== per-process on the real tier) registry -------------
def global_registry() -> MetricRegistry:
    """THE registry of the current loop. One loop per process on the real
    tier; a fresh loop (and thus a fresh registry) per sim run, which is
    what makes same-seed snapshot bit-identity testable."""
    loop = current_loop()
    reg = getattr(loop, "_metric_registry", None)
    if reg is None:
        reg = loop._metric_registry = MetricRegistry()
    return reg
