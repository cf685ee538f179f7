"""Open-system serving layer, in PyTorch: arrivals -> bounded engine pool
-> tails (the port of ``repro.serving``).

See :mod:`repro_torch.serving.runner` for the serving loop,
:mod:`repro_torch.serving.arrivals` for the schedule generators, and
:mod:`repro_torch.serving.analytic` for the M/M/c validation oracle
(Thomasian, arXiv:2404.02276). DESIGN.md §10 documents the layer.

Quickstart::

    from repro_torch.core.lock import WorkloadSpec
    from repro_torch.serving import ServeCell, poisson, serve
    hot = WorkloadSpec(kind="hotspot_update", txn_len=2, n_rows=4096)
    cells = [ServeCell(name=p, schedule=poisson(0.002, 240_000, seed=17),
                       workload=hot, n_threads=32, preset=p)
             for p in ("mysql", "group", "brook2pl")]
    res = serve(cells, seg_ticks=10_000, device="cuda")
    print(res.serving["group"].p99_us)
"""
from .arrivals import (ArrivalSchedule, bursty, flash_crowd, poisson,
                       saturating, uniform)
from .runner import (ServeCell, ServeResults, ServingRecord, ServingResult,
                     serve)
from .analytic import (erlang_c, mmc_wait_ticks, pool_capacity_tps,
                       predicted_response_ticks, predicted_util,
                       service_ticks, write_fraction)
from .metrics import MetricFamily, ServingMetrics, render_families

__all__ = [
    "ArrivalSchedule", "poisson", "bursty", "flash_crowd", "uniform",
    "saturating",
    "ServeCell", "ServeResults", "ServingRecord", "ServingResult", "serve",
    "erlang_c", "mmc_wait_ticks", "pool_capacity_tps",
    "predicted_response_ticks", "predicted_util", "service_ticks",
    "write_fraction",
    "MetricFamily", "ServingMetrics", "render_families",
]
