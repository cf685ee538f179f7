"""The group-locking segment reduction: CUDA kernel, plain version and the
hotspot-grouped scatter-apply built on it."""
from .kernel import segment_sums
from .ops import grouped_scatter_apply, hot_groups
from .ref import segment_sums_ref, grouped_apply_ref

__all__ = ["segment_sums", "grouped_scatter_apply", "hot_groups",
           "segment_sums_ref", "grouped_apply_ref"]
