"""Optimizer and gradient paths of the port: AdamW (32/16/8-bit moments),
the hotspot-grouped embedding gradient and the int8 ring all-reduce."""
from . import adamw
from .adamw import (AdamWConfig, AdamWState, init, apply, schedule,
                    global_norm)
from .hotspot_update import grouped_embed, serial_embed
from .compression import quantized_psum, quantize, dequantize

__all__ = ["adamw", "AdamWConfig", "AdamWState", "init", "apply",
           "schedule", "global_norm", "grouped_embed", "serial_embed",
           "quantized_psum", "quantize", "dequantize"]
