"""Live serving metrics: a Prometheus-text-exposition registry.

A copy of ``repro.serving.metrics`` (host code only): both packages render
the same exposition text from the same records.

The serving loop (:func:`repro_torch.serving.runner.serve`) observes the open
system only at segment boundaries — that is the natural scrape cadence,
so the registry is updated per :class:`~repro_torch.serving.runner.ServingRecord`
(pass ``metrics=ServingMetrics()`` to ``serve``) and rendered on demand in
the Prometheus text exposition format (version 0.0.4): ``# HELP`` /
``# TYPE`` headers, ``name{label="v"} value`` samples.

Design points (DESIGN.md §14):

* **Counters are cumulative and monotonic** — ``*_total`` families sum
  window deltas (arrived/rejected/shed/completed/sla_miss/commits), so a
  real Prometheus server scraping :func:`ServingMetrics.serve_http` at any
  cadence sees correct rates via ``rate()`` regardless of how boundary
  windows align with scrapes.
* **Gauges are last-window observations** — queue depth, in-flight,
  window percentiles, throughput, occupancy, and the SLA burn rate
  (window miss fraction / SLA budget, the standard error-budget-consumption
  dial; 1.0 = burning exactly the budget).
* **Hotspot gauges** surface the engine's per-record contention
  accumulator: the top-K rows of the window's ``hotspots`` ranking become
  ``repro_hotspot_wait_ticks{cell,rank,row}`` samples plus a
  ``repro_hotspot_top1_share`` concentration dial. Empty (no samples)
  when the cell runs with ``attrib=False`` — attribution stays opt-in.
* **No daemon required** — ``render()`` returns the exposition text,
  ``dump(path)`` writes it atomically (write-then-rename) for
  node-exporter-textfile-style collection, and ``serve_http(port)``
  starts a stdlib ThreadingHTTPServer for live scraping. Nothing here
  touches the device: every input is a host-side record the serving loop
  already produced.
"""
from __future__ import annotations

import http.server
import os
import threading
from typing import Iterable

__all__ = ["MetricFamily", "ServingMetrics", "render_families"]

_EXPO_VERSION = "0.0.4"


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integers bare, floats via repr."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


class MetricFamily:
    """One named metric family: type + help + labelled samples.

    Samples are keyed by a sorted tuple of ``(label, value)`` pairs.
    Counters enforce monotonicity (``inc`` with a negative delta raises),
    gauges are free-set.
    """

    def __init__(self, name: str, kind: str, help_: str):
        assert kind in ("counter", "gauge"), kind
        self.name = name
        self.kind = kind
        self.help = help_
        self.samples: dict[tuple, float] = {}

    @staticmethod
    def _key(labels: dict) -> tuple:
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def inc(self, value: float = 1.0, **labels) -> None:
        assert self.kind == "counter", self.name
        if value < 0:
            raise ValueError(
                f"counter {self.name} decremented by {value}")
        k = self._key(labels)
        self.samples[k] = self.samples.get(k, 0.0) + float(value)

    def set(self, value: float, **labels) -> None:
        assert self.kind == "gauge", self.name
        self.samples[self._key(labels)] = float(value)

    def clear(self, **label_subset) -> None:
        """Drop samples whose labels include ``label_subset`` (used to
        retire stale top-K hotspot ranks between windows)."""
        sub = set(self._key(label_subset))
        self.samples = {k: v for k, v in self.samples.items()
                        if not sub.issubset(set(k))}

    def get(self, **labels) -> float:
        return self.samples.get(self._key(labels), 0.0)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self.samples):
            if key:
                lbl = ",".join(f'{k}="{_escape_label(v)}"'
                               for k, v in key)
                lines.append(
                    f"{self.name}{{{lbl}}} "
                    f"{_fmt_value(self.samples[key])}")
            else:
                lines.append(f"{self.name} "
                             f"{_fmt_value(self.samples[key])}")
        return "\n".join(lines)


def render_families(families: Iterable[MetricFamily]) -> str:
    """Full exposition text: families in declaration order, trailing \\n."""
    return "\n".join(f.render() for f in families) + "\n"


# (name, kind, help) — declaration order is exposition order
_FAMILIES = (
    ("repro_serving_arrivals_total", "counter",
     "Requests that arrived (admitted or refused)."),
    ("repro_serving_rejected_total", "counter",
     "Requests refused at the admission bound (policy=reject)."),
    ("repro_serving_shed_total", "counter",
     "Queued requests dropped to admit newer ones (policy=shed)."),
    ("repro_serving_completed_total", "counter",
     "Responses observed at boundaries (commits + user aborts)."),
    ("repro_serving_sla_miss_total", "counter",
     "Completions whose response time exceeded the cell SLA."),
    ("repro_serving_commits_total", "counter",
     "Engine transaction commits (goodput numerator)."),
    ("repro_serving_windows_total", "counter",
     "Boundary windows observed."),
    ("repro_serving_queue_depth", "gauge",
     "Admission queue length after dispatch at the last boundary."),
    ("repro_serving_in_flight", "gauge",
     "Dispatched-but-unfinished requests at the last boundary."),
    ("repro_serving_window_ticks", "gauge",
     "Simulated ticks covered by the last window."),
    ("repro_serving_throughput_tps", "gauge",
     "Engine commit throughput over the last window (txn/s)."),
    ("repro_serving_occupancy", "gauge",
     "Engine CPU utilization over the last window (0..1)."),
    ("repro_serving_lock_wait_frac", "gauge",
     "Fraction of thread-ticks spent in lock wait, last window."),
    ("repro_serving_p50_us", "gauge",
     "p50 response time of the last window's completions (us)."),
    ("repro_serving_p99_us", "gauge",
     "p99 response time of the last window's completions (us)."),
    ("repro_serving_p999_us", "gauge",
     "p99.9 response time of the last window's completions (us)."),
    ("repro_serving_sla_burn_rate", "gauge",
     "Window SLA-miss fraction divided by the SLA error budget "
     "(1.0 = consuming exactly the budget; 0 when no SLA/budget)."),
    ("repro_hotspot_wait_ticks", "gauge",
     "Lock-wait ticks charged to a top-K contended record, last window."),
    ("repro_hotspot_grants", "gauge",
     "Lock grants on a top-K contended record, last window."),
    ("repro_hotspot_queue_max", "gauge",
     "Peak global row-queue depth increase observed in the window."),
    ("repro_hotspot_top1_share", "gauge",
     "Top-1 record's share of the window's attributed wait ticks."),
)


class ServingMetrics:
    """Per-cell serving metrics registry (see module docstring).

    ``sla_budget`` is the tolerated SLA-miss fraction the burn rate is
    measured against (SRE convention: burn rate = observed miss fraction
    / budget). ``top_k`` bounds the hotspot gauge fan-out per cell.
    """

    def __init__(self, sla_budget: float = 0.001, top_k: int = 5):
        assert sla_budget > 0 and top_k >= 0
        self.sla_budget = float(sla_budget)
        self.top_k = int(top_k)
        self.families: dict[str, MetricFamily] = {
            name: MetricFamily(name, kind, help_)
            for name, kind, help_ in _FAMILIES}
        self._lock = threading.Lock()

    # -- update -----------------------------------------------------------
    def observe(self, cell_name: str, record) -> None:
        """Fold one boundary :class:`ServingRecord` into the registry."""
        f = self.families
        m = record.metrics
        window = max(1, record.t1 - record.t0)
        with self._lock:
            c = dict(cell=cell_name)
            f["repro_serving_arrivals_total"].inc(record.arrived, **c)
            f["repro_serving_rejected_total"].inc(record.rejected, **c)
            f["repro_serving_shed_total"].inc(record.shed, **c)
            f["repro_serving_completed_total"].inc(record.completed, **c)
            f["repro_serving_sla_miss_total"].inc(record.sla_miss, **c)
            f["repro_serving_commits_total"].inc(m.commits, **c)
            f["repro_serving_windows_total"].inc(1, **c)
            f["repro_serving_queue_depth"].set(record.qlen, **c)
            f["repro_serving_in_flight"].set(record.in_flight, **c)
            f["repro_serving_window_ticks"].set(window, **c)
            f["repro_serving_throughput_tps"].set(m.tps, **c)
            f["repro_serving_occupancy"].set(m.cpu_util, **c)
            f["repro_serving_lock_wait_frac"].set(m.lock_wait_frac, **c)
            f["repro_serving_p50_us"].set(record.p50_us, **c)
            f["repro_serving_p99_us"].set(record.p99_us, **c)
            f["repro_serving_p999_us"].set(record.p999_us, **c)
            miss_frac = (record.sla_miss / record.completed
                         if record.completed else 0.0)
            f["repro_serving_sla_burn_rate"].set(
                miss_frac / self.sla_budget, **c)
            self._observe_hotspots(cell_name, record)

    def _observe_hotspots(self, cell_name: str, record) -> None:
        """Top-K hotspot gauges from the window's ``hotspots`` ranking
        (empty when the cell runs attribution off). Ranks are re-set
        every window; stale higher ranks from a previous, busier window
        are cleared so the exposition never shows ghost rows."""
        f = self.families
        hot = list(getattr(record.metrics, "hotspots", []))[:self.top_k]
        for fam in ("repro_hotspot_wait_ticks", "repro_hotspot_grants"):
            f[fam].clear(cell=cell_name)
        total_wait = 0
        qmax = 0
        for rank, h in enumerate(hot):
            lbl = dict(cell=cell_name, rank=str(rank), row=str(h["row"]))
            f["repro_hotspot_wait_ticks"].set(h["wait_ticks"], **lbl)
            f["repro_hotspot_grants"].set(h["grants"], **lbl)
            qmax = max(qmax, int(h["queue_max"]))
        for h in getattr(record.metrics, "hotspots", []):
            total_wait += int(h["wait_ticks"])
        f["repro_hotspot_queue_max"].set(qmax, cell=cell_name)
        top1 = int(hot[0]["wait_ticks"]) if hot else 0
        f["repro_hotspot_top1_share"].set(
            top1 / total_wait if total_wait else 0.0, cell=cell_name)

    # -- read -------------------------------------------------------------
    def get(self, family: str, **labels) -> float:
        return self.families[family].get(**labels)

    def render(self) -> str:
        """The full Prometheus text exposition (version 0.0.4)."""
        with self._lock:
            return render_families(self.families.values())

    def dump(self, path) -> str:
        """Write the exposition atomically (textfile-collector style)."""
        text = self.render()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
        return text

    # -- scrape endpoint --------------------------------------------------
    def serve_http(self, port: int = 0, host: str = "127.0.0.1"):
        """Start a daemon-thread HTTP server exposing ``/metrics``.

        Returns the :class:`http.server.ThreadingHTTPServer`; read the
        bound port off ``server.server_address[1]`` (``port=0`` picks a
        free one) and stop it with ``server.shutdown()``.
        """
        registry = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):             # noqa: N802 (stdlib API)
                if self.path.split("?")[0] not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                body = registry.render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    f"text/plain; version={_EXPO_VERSION}; "
                    "charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):     # quiet by default
                pass

        server = http.server.ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=server.serve_forever,
                         daemon=True).start()
        return server
