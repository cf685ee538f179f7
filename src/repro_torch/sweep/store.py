"""JSON results store for sweep runs (a copy of ``repro.sweep.store``:
the two packages write and read the same documents, under the same schema
tags).

One sweep -> one JSON document: run metadata, per-bucket compile/wall
accounting, and one record per point (full config + extracted metrics).
Records are plain dicts built from the dataclasses, so downstream tooling
(benchmark trackers, plotting, PR-over-PR perf trajectories) needs no
package imports to read them.

Schema ``repro.sweep/v2`` adds an optional per-point ``segments`` array —
the governed-run time series (one record per engine segment: window
tps/aborts, the preset the governor chose, end-of-segment contention
state). Points without a time series simply omit the key, so v2 documents
of plain sweeps are byte-compatible with v1 ones apart from the schema
tag, and :func:`load_results` reads both generations.

Compaction-scheduler runs additionally carry their accounting in the
``buckets`` records (additive ``BucketInfo`` fields, still v2):
``compacted``, ``n_repacks``, ``lane_iters`` (width x slowest-lane
iterations summed over device calls — the modeled lockstep cost), and
``repack_log`` (one ``[n_live, width, max_delta_iters]`` triple per
device call). Sort-then-cut runs write zeros / an empty log.

Schema ``repro.sweep/v3`` (obs layer, additive like v2): point
``metrics`` gain the TickBreakdown attribution (``breakdown`` /
``breakdown_hot`` tick dicts, conservation: values sum to padded-T x
elapsed ticks), and segment records gain per-window ``breakdown`` plus
end-of-segment ``wait_hist`` / ``occ_hist`` log2-bucket distribution
histograms. v1/v2 documents still load.

Schema ``repro.sweep/v4`` (hotspot attribution, additive): point
``metrics`` and segment records gain a ``hotspots`` array — the top-K
rows of the engine's per-record contention accumulator for the run /
window ({"row", "wait_ticks", "grants", "timeouts", "victims",
"queue_sum", "queue_max"} dicts, wait-descending). Empty when the run's
``EngineConfig.attrib`` is off, so v4 documents of attribution-off runs
differ from v3 only by the tag and an empty list. Conservation: the
full (untruncated) accumulator's wait_ticks sum equals
``breakdown["lock_wait"]`` exactly. v1-v3 documents still load.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

from .runner import SweepResults

SCHEMA = "repro.sweep/v4"
SCHEMAS_READABLE = ("repro.sweep/v1", "repro.sweep/v2", "repro.sweep/v3",
                    "repro.sweep/v4")


def point_record(res: SweepResults, name: str,
                 point=None) -> dict:
    p = point or next(pt for pt in res.points if pt.name == name)
    r = res.metrics[name]
    rec = {
        "name": name,
        "protocol": p.protocol,
        "workload": dataclasses.asdict(p.workload),
        "n_threads": p.n_threads,
        "horizon": p.horizon,
        "p_abort": p.p_abort,
        "costs": dataclasses.asdict(p.costs),
        "drain": p.drain,
        "proto_over": dict(p.proto_over),
        "wall_us": res.wall_us[name],
        "metrics": dataclasses.asdict(r),
    }
    segs = res.segments.get(name)
    if segs:
        rec["segments"] = segs
    return rec


def results_doc(res: SweepResults, meta: dict | None = None) -> dict:
    return {
        "schema": SCHEMA,
        "created_unix": time.time(),
        "meta": meta or {},
        "n_points": len(res.points),
        "n_compiles": res.n_compiles,
        "wall_s": res.wall_s,
        "buckets": [dataclasses.asdict(b) for b in res.buckets],
        "points": [point_record(res, p.name, p) for p in res.points],
    }


def save_results(path: str, res: SweepResults,
                 meta: dict | None = None) -> str:
    """Write the sweep to ``path`` (dirs created); returns the path."""
    doc = results_doc(res, meta)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_results(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") not in SCHEMAS_READABLE:
        raise ValueError(f"{path}: not a repro.sweep results file "
                         f"(schema {doc.get('schema')!r})")
    return doc
