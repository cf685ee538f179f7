"""Batched simulation-fleet subsystem, in PyTorch (the port of
``repro.sweep``).

Runs whole (protocol × workload × thread-count × ...) grids as packs of
lanes on one card — one sequence of torch calls steps every lane of a
pack — with bit-exact parity to per-config ``simulate()`` runs.

Quickstart::

    from repro_torch.sweep import grid, run_sweep, summarize
    pts = grid(["mysql", "group"], HOT, [64, 256], horizon=200_000)
    res = run_sweep(pts)                 # device=None: the CUDA card
    print("\\n".join(summarize(res)))
"""
from .grid import SweepPoint, point, grid, zip_grid, expand, PROTOCOLS_ALL
from .runner import run_sweep, summarize, SweepResults, BucketInfo
from .store import save_results, load_results, results_doc, point_record

__all__ = [
    "SweepPoint", "point", "grid", "zip_grid", "expand", "PROTOCOLS_ALL",
    "run_sweep", "summarize", "SweepResults", "BucketInfo",
    "save_results", "load_results", "results_doc", "point_record",
]
