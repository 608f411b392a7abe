"""Optimizer substrate: AdamW with schedules, global-norm clipping and
int8 error-feedback gradient compression, on trees of tensors.  The
reference's ZeRO-1 optimizer-state sharding (``zero1_spec``) shards over a
mesh of several devices and is not ported yet (ROADMAP A3.4)."""

from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                    clip_by_global_norm)
from .schedules import cosine_schedule, linear_warmup
from .compression import (compress_int8, decompress_int8,
                          make_error_feedback_state, ef_compress_update)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm", "cosine_schedule", "linear_warmup",
           "compress_int8", "decompress_int8", "make_error_feedback_state",
           "ef_compress_update"]
