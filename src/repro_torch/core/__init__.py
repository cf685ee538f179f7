"""Paper core: TXSQL lock optimizations, faithful (lock/) and adapted."""
from .hotspot import (DEFAULT_THRESHOLD, HotspotState, batch_counts,
                      detect_hot, detect_hot_queue, init_hotspot,
                      update_hotspot, update_hotspot_queue)
from .group_apply import (Groups, form_groups, group_apply, hotspot_apply,
                          scatter_serial)
from .dependency import DependencyList, DependencyError

__all__ = [
    "DEFAULT_THRESHOLD", "HotspotState", "batch_counts", "detect_hot",
    "detect_hot_queue", "init_hotspot", "update_hotspot",
    "update_hotspot_queue",
    "Groups", "form_groups", "group_apply", "hotspot_apply",
    "scatter_serial", "DependencyList", "DependencyError",
]
