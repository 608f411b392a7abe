"""Step builders of the LM: train, prefill and serve (decode).

Port of ``build_train_step`` / ``build_prefill_step`` / ``build_serve_step``
of ``repro/launch/steps.py`` for one device: there are no shardings, no
ZeRO-1 and no ``jit``.  Each builder returns the step callable and the
shapes of its inputs (``repro_torch.configs.input_specs``), with the model
it runs.

    step = build_prefill_step(cfg, batch=2, seq=8192)   # on the GPU
    logits = step.fn(tokens)                             # (B, 1, V) float32

    step = build_train_step(cfg, batch=4, seq=4096)
    opt_state = adamw_init(dict(step.model.named_parameters()))
    opt_state, metrics = step.fn(opt_state, {"tokens": t, "labels": y})

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
from ..optim import AdamWConfig, adamw_update, cosine_schedule


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


def make_train_step(model: LM, opt: AdamWConfig, warmup_steps: int,
                    total_steps: int, remat: bool = True) -> Callable:
    """``fn(opt_state, tokens, labels, ctx=None) -> (opt_state,
    metrics)``: one training step of ``model`` in place, the reference's
    ``train_step``: the loss (``LM.loss``, each pattern unit recomputed in
    the backward pass with ``remat``) and its gradients, then AdamW at the
    cosine schedule's rate for the state's step (``warmup_steps`` of linear
    warmup, decay over ``total_steps``).  Turns the model's gradients on.
    ``metrics``: the loss and the gradients' global norm before clipping,
    float32 0-d tensors on the model's device (read them only where the
    host needs them: each read waits for the device)."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def train_step(opt_state, tokens: torch.Tensor, labels: torch.Tensor,
                   ctx: Optional[torch.Tensor] = None):
        for p in params.values():
            p.grad = None
        loss = model.loss(tokens, labels, ctx, remat=remat)
        loss.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        lr = cosine_schedule(opt_state["step"], warmup_steps, total_steps,
                             opt.lr)
        with torch.no_grad():
            new_p, opt_state, metrics = adamw_update(params, grads,
                                                     opt_state, opt, lr=lr)
            for n, p in params.items():
                p.copy_(new_p[n])
                p.grad = None
        metrics["loss"] = loss.detach()
        return opt_state, metrics

    return train_step


def build_train_step(cfg: ArchConfig, shape: str = "train_4k", *,
                     opt: AdamWConfig = AdamWConfig(), remat: bool = True,
                     total_steps: int = 10000, model: Optional[LM] = None,
                     device: DeviceLike = None, batch: Optional[int] = None,
                     seq: Optional[int] = None,
                     seed: int = 0) -> BuiltStep:
    """``fn(opt_state, batch) -> (opt_state, metrics)``: one AdamW step of
    the model on ``batch = {"tokens", "labels"[, "ctx"]}`` (shapes
    ``in_specs``: the cell's, cut by ``batch`` / ``seq``), the parameters
    updated in place; 200 warmup steps then cosine decay over
    ``total_steps``, as the reference.  ``opt_state`` starts as
    ``adamw_init(dict(step.model.named_parameters()))``.  On the card a
    GQA layer's gradient comes from the attention backward kernels (one
    backward launch per layer and step, the forward kernel twice with
    remat)."""
    lm = _model(cfg, model, device, seed)
    specs = input_specs(cfg, shape, batch=batch, seq=seq)
    step = make_train_step(lm, opt, 200, total_steps, remat)

    def train_step(opt_state, batch: Dict[str, torch.Tensor]):
        return step(opt_state, batch["tokens"], batch["labels"],
                    batch.get("ctx"))

    return BuiltStep(train_step, specs, lm)


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
