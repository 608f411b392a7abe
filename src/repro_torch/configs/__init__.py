"""Architecture configs and input-shape cells.

Port of ``repro/configs``.  ``get_config(name)`` returns the full published
config, ``reduced(name)`` a small config of the same family for CPU tests,
``input_specs(cfg, shape)`` the concrete shape and dtype of every input of
a (arch x shape) cell.  All ten of the reference's architectures are
registered: gemma2-9b, the dense stablelm-1.6b and codeqwen1.5-7b, the
encoder hubert-xlarge (frame-embedding inputs), the MoE deepseek-moe-16b
and moonshot-v1-16b-a3b, minicpm3-4b (MLA), llama-3.2-vision-11b
(cross-attention over an image context), the hybrid zamba2-7b (Mamba2
layers and a shared attention block) and xlstm-350m (mLSTM and sLSTM
blocks).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.lm import ArchConfig, block_cache_shapes

from . import (codeqwen1_5_7b, deepseek_moe_16b, gemma2_9b, hubert_xlarge,
               llama3_2_vision_11b, minicpm3_4b, moonshot_v1_16b_a3b,
               stablelm_1_6b, xlstm_350m, zamba2_7b)

_MODULES = {
    "zamba2-7b": zamba2_7b,
    "gemma2-9b": gemma2_9b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "stablelm-1.6b": stablelm_1_6b,
    "minicpm3-4b": minicpm3_4b,
    "hubert-xlarge": hubert_xlarge,
    "llama-3.2-vision-11b": llama3_2_vision_11b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "xlstm-350m": xlstm_350m,
}
#: the reference's architectures not registered yet: none
NOT_PORTED: Tuple[str, ...] = ()

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    return _MODULES[name].CONFIG


def reduced(name: str) -> ArchConfig:
    return _MODULES[name].reduced()


# --------------------------------------------------------------------------
# shape cells (seq_len, global_batch) -- assigned to every LM arch
# --------------------------------------------------------------------------

SHAPES: Dict[str, Tuple[int, int]] = {
    "train_4k": (4096, 256),
    "prefill_32k": (32768, 32),
    "decode_32k": (32768, 128),
    "long_500k": (524288, 1),
}

DECODE_SHAPES = ("decode_32k", "long_500k")


def cell_skip_reason(cfg: ArchConfig, shape: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the documented skip."""
    if cfg.encoder_only and shape in DECODE_SHAPES:
        return "encoder-only arch has no decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return "full-attention arch; 500k context needs sub-quadratic attn"
    return None


def input_specs(cfg: ArchConfig, shape: str, batch: Optional[int] = None,
                seq: Optional[int] = None) -> Dict[str, Any]:
    """``(shape, dtype)`` of every input of a cell's step, the cell's
    sequence length and batch unless ``seq`` / ``batch`` cut them:

    * train_*   -> {tokens, labels [, ctx]}
    * prefill_* -> {tokens [, ctx]}
    * decode_* / long_* -> {token, pos, caches [, ctx]}: ``pos`` is a
      Python int (shape ()), ``caches`` a list of each layer's
      {name: (shape, dtype)}, nested as the cache (None for a
      cross-attention layer)

    Audio and encoder-only models (hubert) take precomputed frame
    embeddings ``(b, s, d_model)`` in the model's type for ``tokens`` and
    ``token``, as the reference's stub frontend.  A VLM (llama-vision)
    also takes ``ctx``, the stub vision tower's patch embeddings
    ``(b, n_ctx_tokens, d_model)`` in the model's type, in every cell.
    """
    s0, b0 = SHAPES[shape]
    seq, batch = seq or s0, batch or b0

    def tok(b, s):
        if cfg.encoder_only or cfg.family == "audio":
            return ((b, s, cfg.d_model), cfg.dtype)
        return ((b, s), torch.int32)

    if shape.startswith("train"):
        specs = {"tokens": tok(batch, seq),
                 "labels": ((batch, seq), torch.int32)}
    elif shape.startswith("prefill"):
        specs = {"tokens": tok(batch, seq)}
    else:
        specs = {"token": tok(batch, 1), "pos": ((), torch.int32),
                 "caches": [block_cache_shapes(kind, cfg, batch, seq)
                            for kind in cfg.layer_kinds]}
    if cfg.family == "vlm":
        specs["ctx"] = ((batch, cfg.n_ctx_tokens, cfg.d_model), cfg.dtype)
    return specs
