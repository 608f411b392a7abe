"""Step builders of the LM: train, prefill and serve (decode), and the
shardings of the decode caches and the optimizer state.

Port of ``repro/launch/steps.py``, without ``jit``.  Each builder returns
the step callable and the shapes of its inputs
(``repro_torch.configs.input_specs``), with the model it runs and a
callable that makes the optimizer state.

    step = build_prefill_step(cfg, batch=2, seq=8192)   # on the GPU
    logits = step.fn(tokens)                             # (B, 1, V) float32

    step = build_train_step(cfg, batch=4, seq=4096)
    opt_state = step.init_opt()
    opt_state, metrics = step.fn(opt_state, {"tokens": t, "labels": y})

    mesh = make_host_mesh(2, devices=["cuda:0"] * 4)     # (data 2, model 2)
    step = build_train_step(cfg, batch=4, seq=4096, mesh=mesh, zero1=True)

With ``mesh=`` the train and prefill steps run on a
:class:`~repro_torch.models.sharded_lm.ShardedLM` (the dense GQA, MLA,
cross-attention and Mamba2 configs, zamba2's shared attention block
included: tensor parallel over ``model``, data parallel
over ``data``, ZeRO-1 when ``zero1``); the global batch, and a VLM's
image context with it, is split in row blocks over the data replicas.
:func:`cache_shardings` (the decode caches' layout) and
:func:`opt_shardings` give the reference's layouts; sharded decode does
not run yet (ROADMAP A3.4).

``tokens`` are token ids (B, S), or frame embeddings (B, S, d_model) for an
audio model (hubert-xlarge), as ``step.in_specs["tokens"]`` says.  A VLM
(llama-3.2-vision-11b) also takes the image context, ``fn(tokens, ctx)``
and ``fn(token, pos, caches, ctx)``, of ``step.in_specs["ctx"]``.

The builders run on the current CUDA device unless ``device="cpu"`` is
passed, and raise when there is none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from ..configs import cell_skip_reason, input_specs
from ..core.device import DeviceLike, resolve_device
from ..distributed.sharding import batch_axes
from ..models.common import NamedSharding, P, ShardingRules
from ..models.lm import LM, ArchConfig
from ..models.sharded_lm import ShardedLM
from ..optim import (AdamWConfig, adamw_init, adamw_init_mesh, adamw_update,
                     adamw_update_mesh, cosine_schedule, zero1_spec)


# --------------------------------------------------------------------------
# cache and optimizer-state shardings
# --------------------------------------------------------------------------

def cache_shardings(rules: ShardingRules, cache_shapes):
    """Shardings of the decode caches: ``cache_shapes`` is the port's list
    of each layer's ``{name: (shape, dtype)}`` (``input_specs(...)
    ["caches"]``, nested as the cache; None for a cross-attention layer),
    and the result has its structure.  The reference's heuristic on its
    layers: the batch axis over ("pod", "data"); then axis 1 (heads-like)
    on "model" when divisible, else the largest divisible trailing axis
    (the 32k sequence axis when kv-heads = 8 < 16); with the batch axes
    idle (a global batch of 1), the largest remaining divisible axis over
    them.  Integer ``pos`` slot arrays are replicated.  The reference's
    stacked caches carry a leading layers axis, replicated; the port's
    layers each hold their own."""
    mesh = rules.mesh
    model_size = mesh.shape["model"]
    batch = rules.rules.get("batch")
    bsz = rules._axis_size(batch)

    def one(leaf):
        shape, dtype = tuple(leaf[0]), leaf[1]
        if not dtype.is_floating_point or len(shape) < 2:
            return NamedSharding(mesh, P())
        entries: list = [None] * len(shape)
        batch_used = shape[0] % bsz == 0 and shape[0] > 0
        if batch_used:
            entries[0] = batch
        cand = None
        if len(shape) > 2 and shape[1] % model_size == 0:
            cand = 1
        else:
            trailing = [(i, s) for i, s in enumerate(shape[1:], 1)
                        if s % model_size == 0]
            if trailing:
                cand = max(trailing, key=lambda t: t[1])[0]
        if cand is not None:
            entries[cand] = "model"
        if not batch_used:
            free = [(i, s) for i, s in enumerate(shape[1:], 1)
                    if entries[i] is None and s % bsz == 0]
            if free:
                entries[max(free, key=lambda t: t[1])[0]] = batch
        return NamedSharding(mesh, P(*entries))

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return one(node)

    return [walk(layer) for layer in cache_shapes]


def opt_shardings(p_shard, p_shape, mesh, zero1: bool = False):
    """The optimizer state's shardings, from the parameters' (trees of the
    reference's structure, :func:`param_shardings` and
    ``LM.param_shapes()``): the moments as the parameters, or with
    ``zero1`` each over the data axes by :func:`zero1_spec`; the step
    replicated."""
    if not zero1:
        moments = p_shard
    else:
        axes = batch_axes(mesh)

        def z1(ns, shape):
            if isinstance(ns, dict):
                return {k: z1(ns[k], shape[k]) for k in ns}
            return NamedSharding(mesh, zero1_spec(ns.spec, shape, axes,
                                                  mesh))
        moments = z1(p_shard, p_shape)
    return {"m": moments, "v": moments, "step": NamedSharding(mesh, P())}


# --------------------------------------------------------------------------
# builders
# --------------------------------------------------------------------------

@dataclasses.dataclass
class BuiltStep:
    fn: Callable                   # the step
    in_specs: Dict[str, Any]       # {input: (shape, dtype)}
    model: Union[LM, ShardedLM]
    init_opt: Optional[Callable] = None   # () -> a fresh optimizer state


def _model(cfg: ArchConfig, model, device: DeviceLike, seed: int,
           mesh=None):
    """``model`` checked against ``cfg``, or a new one drawn from ``seed``
    on ``device`` (on the mesh's first device, then split, with
    ``mesh``).  With a mesh, a one-device model is split onto it."""
    if model is not None:
        if model.cfg != cfg:
            raise ValueError(f"the model runs {model.cfg.name}, not "
                             f"{cfg.name}")
        if mesh is None or isinstance(model, ShardedLM):
            if isinstance(model, ShardedLM) and model.mesh is not mesh:
                raise ValueError("the model lies on another mesh")
            return model
        return ShardedLM(model, mesh)
    dev = resolve_device(mesh.devices.flat[0] if mesh is not None
                         else device)
    lm = LM(cfg, device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed))
    return lm if mesh is None else ShardedLM(lm, mesh)


def make_train_step(model: Union[LM, ShardedLM], opt: AdamWConfig,
                    warmup_steps: int, total_steps: int, remat: bool = True,
                    zero1: bool = True) -> Callable:
    """``fn(opt_state, tokens, labels, ctx=None) -> (opt_state,
    metrics)``: one training step of ``model`` in place, the reference's
    ``train_step``: the loss (``LM.loss``, each pattern unit recomputed in
    the backward pass with ``remat``) and its gradients, then AdamW at the
    cosine schedule's rate for the state's step (``warmup_steps`` of linear
    warmup, decay over ``total_steps``).  Turns the model's gradients on.
    ``metrics``: the loss and the gradients' global norm before clipping,
    float32 0-d tensors on the model's (first) device (read them only
    where the host needs them: each read waits for the device).  A
    :class:`ShardedLM` takes the global batch and steps with
    :func:`adamw_update_mesh` (``zero1``: the state's layout, from
    ``adamw_init_mesh(model, zero1)``)."""
    model.requires_grad_(True)
    if isinstance(model, ShardedLM):
        return _make_mesh_train_step(model, opt, warmup_steps, total_steps,
                                     remat, zero1)
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


def _make_mesh_train_step(model: ShardedLM, opt: AdamWConfig,
                          warmup_steps: int, total_steps: int, remat: bool,
                          zero1: bool) -> Callable:
    def train_step(opt_state, tokens: torch.Tensor, labels: torch.Tensor,
                   ctx: Optional[torch.Tensor] = None):
        for p in model.parameters():
            p.grad = None
        loss = model.loss(tokens, labels, ctx, remat=remat)
        loss.backward()
        lr = cosine_schedule(opt_state["step"], warmup_steps, total_steps,
                             opt.lr)
        with torch.no_grad():
            opt_state, metrics = adamw_update_mesh(model, opt_state, opt,
                                                   lr=lr, zero1=zero1)
        metrics["loss"] = loss.detach()
        return opt_state, metrics

    return train_step


def build_train_step(cfg: ArchConfig, shape: str = "train_4k", *,
                     opt: AdamWConfig = AdamWConfig(), remat: bool = True,
                     total_steps: int = 10000, model=None,
                     device: DeviceLike = None, batch: Optional[int] = None,
                     seq: Optional[int] = None, seed: int = 0, mesh=None,
                     zero1: bool = True) -> BuiltStep:
    """``fn(opt_state, batch) -> (opt_state, metrics)``: one AdamW step of
    the model on ``batch = {"tokens", "labels"[, "ctx"]}`` (shapes
    ``in_specs``: the cell's, cut by ``batch`` / ``seq``), the parameters
    updated in place; 200 warmup steps then cosine decay over
    ``total_steps``, as the reference.  ``opt_state`` starts as
    ``step.init_opt()``.  On the card a GQA layer's gradient comes from
    the attention backward kernels (one backward launch per layer, shard
    and step, the forward kernel twice with remat).  With ``mesh`` the
    model is a :class:`ShardedLM` (``model`` may be one, or a one-device
    ``LM`` to split), the batch global, and ``zero1`` shards the moments
    over the data axes."""
    lm = _model(cfg, model, device, seed, mesh)
    specs = input_specs(cfg, shape, batch=batch, seq=seq)
    step = make_train_step(lm, opt, 200, total_steps, remat, zero1)

    def train_step(opt_state, batch: Dict[str, torch.Tensor]):
        return step(opt_state, batch["tokens"], batch["labels"],
                    batch.get("ctx"))

    if isinstance(lm, ShardedLM):
        def init_opt():
            return adamw_init_mesh(lm, zero1)
    else:
        def init_opt():
            return adamw_init(dict(lm.named_parameters()))
    return BuiltStep(train_step, specs, lm, init_opt)


def build_prefill_step(cfg: ArchConfig, shape: str = "prefill_32k", *,
                       batch: Optional[int] = None, seq: Optional[int] = None,
                       model=None, device: DeviceLike = None,
                       seed: int = 0, mesh=None) -> BuiltStep:
    """``fn(tokens, ctx=None) -> logits``: last-position float32 logits
    (B, 1, V) of the prompts (B, S), or of frame embeddings (B, S, d_model)
    for an audio model; ``ctx``, the image context (B, n_ctx_tokens,
    d_model), is required by a VLM.  ``batch`` / ``seq`` cut the cell's
    shape; the model is ``model``, or a new one with weights drawn from
    ``seed``; with ``mesh`` a :class:`ShardedLM` (the train step's
    forward; the logits on the mesh's first device)."""
    lm = _model(cfg, model, device, seed, mesh)
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
