"""Step builders of the LM serving path: prefill and serve (decode).

Port of ``build_prefill_step`` / ``build_serve_step`` of
``repro/launch/steps.py`` for one device: there are no shardings and no
``jit``.  Each builder returns the step callable and the shapes of its
inputs (``repro_torch.configs.input_specs``), with the model it runs.  The
training builder is not ported yet (ROADMAP A3).

    step = build_prefill_step(cfg, batch=2, seq=8192)   # on the GPU
    logits = step.fn(tokens)                             # (B, 1, V) float32

``tokens`` are token ids (B, S), or frame embeddings (B, S, d_model) for an
audio model (hubert-xlarge), as ``step.in_specs["tokens"]`` says.  A VLM
(llama-3.2-vision-11b) also takes the image context, ``fn(tokens, ctx)``
and ``fn(token, pos, caches, ctx)``, of ``step.in_specs["ctx"]``.

The builders run on the current CUDA device unless ``device="cpu"`` is
passed, and raise when there is none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..configs import cell_skip_reason, input_specs
from ..core.device import DeviceLike, resolve_device
from ..models.lm import LM, ArchConfig


@dataclasses.dataclass
class BuiltStep:
    fn: Callable                   # the step
    in_specs: Dict[str, Any]       # {input: (shape, dtype)}
    model: LM


def _model(cfg: ArchConfig, model: Optional[LM], device: DeviceLike,
           seed: int) -> LM:
    if model is not None:
        if model.cfg != cfg:
            raise ValueError(f"the model runs {model.cfg.name}, not "
                             f"{cfg.name}")
        return model
    dev = resolve_device(device)
    return LM(cfg, device=dev,
              generator=torch.Generator(device=dev).manual_seed(seed))


def build_prefill_step(cfg: ArchConfig, shape: str = "prefill_32k", *,
                       batch: Optional[int] = None, seq: Optional[int] = None,
                       model: Optional[LM] = None, device: DeviceLike = None,
                       seed: int = 0) -> BuiltStep:
    """``fn(tokens, ctx=None) -> logits``: last-position float32 logits
    (B, 1, V) of the prompts (B, S), or of frame embeddings (B, S, d_model)
    for an audio model; ``ctx``, the image context (B, n_ctx_tokens,
    d_model), is required by a VLM.  ``batch`` / ``seq`` cut the cell's
    shape; the model is ``model``, or a new one with weights drawn from
    ``seed``."""
    lm = _model(cfg, model, device, seed)
    specs = input_specs(cfg, shape, batch=batch, seq=seq)

    @torch.inference_mode()
    def prefill(tokens: torch.Tensor,
                ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
        return lm.prefill(tokens, ctx)

    return BuiltStep(prefill, specs, lm)


def build_serve_step(cfg: ArchConfig, shape: str = "decode_32k", *,
                     batch: Optional[int] = None, seq: Optional[int] = None,
                     model: Optional[LM] = None, device: DeviceLike = None,
                     seed: int = 0) -> BuiltStep:
    """``fn(token, pos, caches, ctx=None) -> (logits, caches)``: one
    decode step of tokens (B, 1) at position ``pos`` on caches from
    ``model.init_cache(batch, seq)``, updated in place (the reference
    donates them; a Mamba2 layer's cache is nested, its conv states and
    float32 state, and a ``mamba_shared`` layer's also holds its shared-block
    K/V); a VLM takes its image context ``ctx`` at every step.
    An encoder-only config has no decode step: it raises with the cell's
    skip reason."""
    reason = cell_skip_reason(cfg, shape) if cfg.encoder_only else None
    if reason is not None:
        raise ValueError(f"{cfg.name}, {shape}: {reason}")
    lm = _model(cfg, model, device, seed)
    specs = input_specs(cfg, shape, batch=batch, seq=seq)

    @torch.inference_mode()
    def serve_step(token: torch.Tensor, pos: int, caches,
                   ctx: Optional[torch.Tensor] = None):
        return lm.decode_step(token, pos, caches, ctx)

    return BuiltStep(serve_step, specs, lm)
