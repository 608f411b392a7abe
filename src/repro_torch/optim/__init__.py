"""Optimizer substrate: AdamW with schedules, global-norm clipping and
int8 error-feedback gradient compression, on trees of tensors; on a mesh,
AdamW with the reference's ZeRO-1 optimizer-state sharding
(``zero1_spec``)."""

from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                    clip_by_global_norm, zero1_spec, adamw_init_mesh,
                    adamw_update_mesh, gather_opt_mesh, split_opt_mesh)
from .schedules import cosine_schedule, linear_warmup
from .compression import (compress_int8, decompress_int8,
                          make_error_feedback_state, ef_compress_update)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm", "cosine_schedule", "linear_warmup",
           "compress_int8", "decompress_int8", "make_error_feedback_state",
           "ef_compress_update", "zero1_spec", "adamw_init_mesh",
           "adamw_update_mesh", "gather_opt_mesh", "split_opt_mesh"]
