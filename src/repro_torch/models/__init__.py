"""Model substrate of the port: functional layers, the mixers (GQA global
and sliding-window attention, MLA, RG-LRU, SSD), MoE and LM assembly for
serving and training (train-mode logits and the loss, prefill, decode)."""
from .common import (ParamSpec, spec, init_params, count_params, is_spec,
                     tree_map_specs, tree_leaves)
from .lm import (lm_spec, forward, prefill, decode_step, LMOutput,
                 cross_entropy, chunked_cross_entropy, loss_fn)
from .transformer import (lm_cache_shapes, lm_init_cache, block_spec,
                          block_apply)

__all__ = [
    "ParamSpec", "spec", "init_params", "count_params", "is_spec",
    "tree_map_specs", "tree_leaves", "lm_spec", "forward", "prefill",
    "decode_step", "LMOutput", "cross_entropy", "chunked_cross_entropy",
    "loss_fn", "lm_cache_shapes", "lm_init_cache", "block_spec",
    "block_apply",
]
