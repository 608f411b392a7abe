"""The composable LM, for the attention, MLA, cross-attention, MoE, Mamba2
and xLSTM blocks, on one device (the GQA, MLA and cross-attention blocks
also run on a mesh: :mod:`.sharded_lm`).  ``LM.param_axes`` gives the
reference's logical axes of every leaf, in the reference's tree
(``LM.reference_leaf`` maps each per-layer parameter to its stacked leaf
and repeat).

Port of ``repro/models/lm.py``.  An architecture is a repeating pattern of
typed blocks plus an optional prelude.  The reference stacks each pattern
position's parameters over the repeats and scans over them; the port keeps
one module per layer, in the order the scan runs them: layer
``len(prelude) + r * len(pattern) + i`` is pattern position i of repeat r.

Block kinds ported:

``attn``         pre-norm GQA + pre-norm gated FFN (llama/qwen style)
``attn_local``   same, sliding window + soft-cap (gemma2; sandwich norms)
``attn_global``  same, full attention + soft-cap (gemma2)
``attn_bidir``   non-causal LayerNorm encoder block (hubert)
``moe``          GQA attention + MoE FFN (deepseek, moonshot)
``dense``        GQA attention + dense gated FFN of ``d_ff`` (their first
                 layer)
``mla``          multi-head latent attention + FFN (minicpm3)
``xattn``        gated cross-attention over patch embeddings + FFN
                 (llama-vision)
``mamba``        pre-norm Mamba2 block (zamba2)
``mamba_shared`` a Mamba2 block followed by zamba2's *shared* attention
                 block, an ``attn`` block whose one parameter set,
                 ``LM.shared_attn``, every ``mamba_shared`` layer calls
``mlstm``        pre-norm mLSTM block (xlstm-350m)
``slstm``        pre-norm sLSTM block, its gated FFN inside (xlstm-350m)

Caches: each GQA layer owns ``{"k", "v", "pos"}``, sliding-window layers a
ring of ``min(window, s_max)`` slots; each MLA layer owns the latent
``{"kv_lat", "k_rope", "pos"}``; a cross-attention layer has none (its
slot in the list is ``None``: it re-projects the context every step, as
the reference); a Mamba2 layer owns ``{"conv": {"x", "B", "C"}, "ssm"}``
(the last conv inputs and the float32 state), a ``mamba_shared`` layer
``{"mamba": <that>, "shared": {"k", "v", "pos"}}``, its own K/V cache for
its call of the shared block; an mLSTM layer owns ``{"conv", "C", "n",
"m"}`` (its last conv inputs and a float32 matrix state), an sLSTM layer
``{"c", "n", "m", "y"}`` (float32).  Audio models (hubert) take float
frame embeddings (B, S, d_model) where the others take token ids; a
model with
cross-attention layers (llama-vision) also takes the image context ``ctx``
(B, n_ctx_tokens, d_model), precomputed patch embeddings (the reference's
stub vision tower).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from ..core.device import DeviceLike, resolve_device
from . import attention as attn_mod
from . import ffn as ffn_mod
from . import mamba2 as mamba_mod
from . import moe as moe_mod
from . import xlstm as xlstm_mod
from .attention import AttnConfig, MLAConfig
from .common import (dense_init, embed_init, layer_norm, rms_norm,
                     softmax_xent_chunked)
from .ffn import FFNConfig
from .mamba2 import Mamba2Config
from .moe import MoEConfig
from .xlstm import XLSTMConfig

#: block kinds that attend by GQA (the ones that launch flash_attention in
#: prefill)
ATTN_KINDS = ("attn", "attn_local", "attn_global", "attn_bidir", "dense",
              "moe")
#: block kinds that launch flash_attention once a prefill: the GQA kinds
#: and zamba2's ``mamba_shared``, which calls the shared attention block
#: (MLA and cross-attention run in plain ops, as the reference)
FLASH_KINDS = ATTN_KINDS + ("mamba_shared",)
#: every block kind the port runs
PORTED_KINDS = ATTN_KINDS + ("mla", "xattn", "mamba", "mamba_shared",
                             "mlstm", "slstm")
#: block kinds of the reference that the port does not run yet: none
NOT_PORTED_KINDS: Tuple[str, ...] = ()
#: the xLSTM kinds, each a pre-norm block around its layer
XLSTM_KINDS = ("mlstm", "slstm")


def flash_layers(cfg: "ArchConfig") -> int:
    """flash_attention's launches a prefill: the layers of a
    ``FLASH_KINDS`` kind."""
    return sum(kind in FLASH_KINDS for kind in cfg.layer_kinds)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """The reference's ``ArchConfig``, field for field, with ``dtype`` a
    torch dtype."""
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    pattern: Tuple[str, ...] = ("attn",)
    prelude: Tuple[str, ...] = ()
    head_dim: int = 0                   # 0 -> d_model // n_heads
    # attention extras
    window: int = 0                     # sliding window (attn_local)
    softcap: float = 0.0                # attention logit softcap
    final_softcap: float = 0.0          # final logit softcap (gemma2)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # MLA (minicpm3)
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_expert: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    mamba_head_dim: int = 64
    ssd_chunk: int = 256
    # VLM
    n_ctx_tokens: int = 0               # patch-embedding count (stub frontend)
    # misc
    norm: str = "rms"                   # rms | layer
    activation: str = "silu"
    tie_embed: bool = True
    embed_scale: bool = False           # gemma: x *= sqrt(d)
    encoder_only: bool = False
    sub_quadratic: bool = False         # long_500k eligible
    seq_parallel: bool = False          # block weights replicated on a mesh
    dtype: Any = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_repeats(self) -> int:
        n = self.n_layers - len(self.prelude)
        if n % len(self.pattern):
            raise ValueError(f"{self.name}: {n} layers not divisible by "
                             f"pattern {self.pattern}")
        return n // len(self.pattern)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """The kind of every layer, in the order they run."""
        return tuple(self.prelude) + tuple(self.pattern) * self.n_repeats

    def attn_cfg(self, kind: str) -> AttnConfig:
        """The attention of block ``kind`` (``dense`` and ``moe`` blocks
        attend as ``attn``)."""
        kind = kind if kind.startswith("attn") else "attn"
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_kv,
            head_dim=self.hd,
            causal=not self.encoder_only and kind != "attn_bidir",
            window=self.window if kind == "attn_local" else None,
            softcap=self.softcap or None, qk_norm=self.qk_norm,
            rope_theta=self.rope_theta)

    def mla_cfg(self) -> MLAConfig:
        return MLAConfig(self.d_model, self.n_heads, self.q_lora_rank,
                         self.kv_lora_rank, self.qk_nope_dim,
                         self.qk_rope_dim, self.v_head_dim, self.rope_theta)

    def ffn_cfg(self) -> FFNConfig:
        return FFNConfig(self.d_model, self.d_ff, self.activation,
                         gated=self.norm == "rms")

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(self.d_model, self.d_expert or self.d_ff,
                         self.n_experts, self.top_k, self.n_shared,
                         activation=self.activation)

    def mamba_cfg(self) -> Mamba2Config:
        return Mamba2Config(self.d_model, d_state=self.ssm_state or 64,
                            head_dim=self.mamba_head_dim,
                            chunk=self.ssd_chunk)

    def xlstm_cfg(self) -> XLSTMConfig:
        return XLSTMConfig(self.d_model, n_heads=self.n_heads)

    def param_count(self) -> int:
        """Parameter count, from shapes alone (a model on the meta
        device)."""
        return sum(t.numel() for t in LM(self, device="meta").parameters())


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _norm_init(cfg: ArchConfig, dtype, device) -> Dict[str, torch.Tensor]:
    if cfg.norm == "layer":
        return {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device),
                "bias": torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device)}
    return {"scale": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}


def _apply_norm(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.norm == "layer":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


_NORM_AXES = {"scale": (None,), "bias": (None,)}


def block_axes(kind: str, cfg: Optional[ArchConfig] = None
               ) -> Dict[str, Any]:
    """The reference's logical axes of a block's leaves (a superset: a
    LayerNorm's bias, the QK-norm scales); with ``cfg.seq_parallel`` every
    axis replicated (its block weights are not split)."""
    _check_kind(kind)
    if kind in ("mamba", "mamba_shared"):
        ax = {"ln1": _NORM_AXES, "mamba": mamba_mod.MAMBA2_AXES}
    elif kind == "mlstm":
        ax = {"ln1": _NORM_AXES, "mlstm": xlstm_mod.MLSTM_AXES}
    elif kind == "slstm":
        ax = {"ln1": _NORM_AXES, "slstm": xlstm_mod.SLSTM_AXES}
    else:
        attn = {"mla": attn_mod.MLA_AXES,
                "xattn": attn_mod.CROSS_AXES}.get(kind, attn_mod.GQA_AXES)
        ax = {"ln1": _NORM_AXES, "attn": attn, "ln2": _NORM_AXES}
        if kind == "moe":
            ax["moe"] = moe_mod.MOE_AXES
        else:
            ax["ffn"] = ffn_mod.FFN_AXES
        if kind in ("attn_local", "attn_global"):
            ax["post_ln1"] = _NORM_AXES
            ax["post_ln2"] = _NORM_AXES
    if cfg is not None and cfg.seq_parallel:
        return _map_axes(lambda a: (None,) * len(a), ax)
    return ax


def _map_axes(fn, tree):
    return {k: _map_axes(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def init_block(gen: Optional[torch.Generator], kind: str, cfg: ArchConfig,
               device=None) -> Dict[str, Any]:
    _check_kind(kind)
    dt = cfg.dtype
    if kind in ("mamba", "mamba_shared"):       # the shared block is LM's
        return {"ln1": _norm_init(cfg, dt, device),
                "mamba": mamba_mod.init_mamba2(gen, cfg.mamba_cfg(), dt,
                                               device)}
    if kind in XLSTM_KINDS:
        init = (xlstm_mod.init_mlstm if kind == "mlstm"
                else xlstm_mod.init_slstm)
        return {"ln1": _norm_init(cfg, dt, device),
                kind: init(gen, cfg.xlstm_cfg(), dt, device)}
    if kind == "mla":
        attn = attn_mod.init_mla(gen, cfg.mla_cfg(), dt, device)
    elif kind == "xattn":
        attn = attn_mod.init_cross(gen, cfg.attn_cfg(kind), dt, device)
    else:
        attn = attn_mod.init_gqa(gen, cfg.attn_cfg(kind), dt, device)
    p = {"ln1": _norm_init(cfg, dt, device), "attn": attn,
         "ln2": _norm_init(cfg, dt, device)}
    if kind == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg.moe_cfg(), dt, device)
    elif kind == "dense":                       # always gated, of d_ff
        p["ffn"] = ffn_mod.init_ffn(
            gen, FFNConfig(cfg.d_model, cfg.d_ff, cfg.activation, True), dt,
            device)
    else:
        p["ffn"] = ffn_mod.init_ffn(gen, cfg.ffn_cfg(), dt, device)
    if kind in ("attn_local", "attn_global"):       # gemma2 sandwich norms
        p["post_ln1"] = _norm_init(cfg, dt, device)
        p["post_ln2"] = _norm_init(cfg, dt, device)
    return p


def _attn_then_ffn(p, x: torch.Tensor, a: torch.Tensor, cfg: ArchConfig,
                   moe_stats=None):
    """The rest of a block after its attention output ``a``: the residual
    add (through gemma2's post-norm), then the pre-normed FFN (or MoE) and
    its post-norm, added to the residual.  Returns (x, the MoE aux loss,
    or None for an FFN)."""
    if "post_ln1" in p:
        a = _apply_norm(p["post_ln1"], a, cfg)
    x = x + a
    h = _apply_norm(p["ln2"], x, cfg)
    if "moe" in p:
        f, aux = moe_mod.moe_fwd(p["moe"], h, cfg.moe_cfg(), moe_stats)
    else:
        f, aux = ffn_mod.ffn_fwd(p["ffn"], h, cfg.ffn_cfg()), None
    if "post_ln2" in p:
        f = _apply_norm(p["post_ln2"], f, cfg)
    return x + f, aux


def _need_shared(shared):
    if shared is None:
        raise ValueError("a mamba_shared block needs the shared attention "
                         "block's parameters (LM.shared_attn)")
    return shared


def _need_ctx(ctx):
    if ctx is None:
        raise ValueError("a cross-attention block needs the image context "
                         "ctx (B, n_ctx_tokens, d_model)")
    return ctx


def block_fwd(kind: str, p, x: torch.Tensor, cfg: ArchConfig,
              positions: Optional[torch.Tensor] = None, moe_stats=None,
              ctx: Optional[torch.Tensor] = None, shared=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block.  Returns (x, aux): the MoE aux loss of a
    ``moe`` block, a float32 zero otherwise.  ``moe_stats``: see
    :func:`repro_torch.models.moe.moe_fwd`; ``ctx``: the image context of
    an ``xattn`` block; ``shared``: the shared attention block of a
    ``mamba_shared`` block (each read by no other kind)."""
    _check_kind(kind)
    h = _apply_norm(p["ln1"], x, cfg)
    if kind in ("mamba", "mamba_shared"):
        x = x + mamba_mod.mamba2_fwd(p["mamba"], h, cfg.mamba_cfg())[0]
        if kind == "mamba_shared":      # the shared block is an attn block
            x = block_fwd("attn", _need_shared(shared), x, cfg,
                          positions=positions)[0]
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in XLSTM_KINDS:
        fwd = xlstm_mod.mlstm_fwd if kind == "mlstm" else xlstm_mod.slstm_fwd
        x = x + fwd(p[kind], h, cfg.xlstm_cfg())[0]
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "mla":
        a = attn_mod.mla_fwd(p["attn"], h, cfg.mla_cfg(), positions=positions)
    elif kind == "xattn":
        a = attn_mod.cross_fwd(p["attn"], h, _need_ctx(ctx),
                               cfg.attn_cfg(kind))
    else:
        a = attn_mod.gqa_fwd(p["attn"], h, cfg.attn_cfg(kind),
                             positions=positions)
    x, aux = _attn_then_ffn(p, x, a, cfg, moe_stats)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def block_decode(kind: str, p, x: torch.Tensor, cache, cfg: ArchConfig,
                 pos: int, ctx: Optional[torch.Tensor] = None, shared=None):
    """Single-token step.  Returns (x, cache); an ``xattn`` block attends
    over ``ctx`` anew and has no cache (None in, None out); a
    ``mamba_shared`` block calls ``shared`` on its own ``cache["shared"]``."""
    _check_kind(kind)
    if kind == "attn_bidir":
        raise ValueError("an encoder block has no decode step")
    h = _apply_norm(p["ln1"], x, cfg)
    if kind in ("mamba", "mamba_shared"):
        mcache = cache["mamba"] if kind == "mamba_shared" else cache
        m, mcache = mamba_mod.mamba2_decode(p["mamba"], h, mcache,
                                            cfg.mamba_cfg())
        x = x + m
        if kind == "mamba_shared":
            x, scache = block_decode("attn", _need_shared(shared), x,
                                     cache["shared"], cfg, pos)
            return x, {"mamba": mcache, "shared": scache}
        return x, mcache
    if kind in XLSTM_KINDS:
        dec = (xlstm_mod.mlstm_decode if kind == "mlstm"
               else xlstm_mod.slstm_decode)
        m, cache = dec(p[kind], h, cache, cfg.xlstm_cfg())
        return x + m, cache
    if kind == "mla":
        a, cache = attn_mod.mla_decode(p["attn"], h, cache, cfg.mla_cfg(),
                                       pos)
    elif kind == "xattn":
        a = attn_mod.cross_fwd(p["attn"], h, _need_ctx(ctx),
                               cfg.attn_cfg(kind))
    else:
        a, cache = attn_mod.gqa_decode(p["attn"], h, cache,
                                       cfg.attn_cfg(kind), pos)
    return _attn_then_ffn(p, x, a, cfg)[0], cache


def block_cache_shapes(kind: str, cfg: ArchConfig, batch: int, s_max: int
                       ) -> Optional[Dict[str, Any]]:
    """``{name: (shape, dtype)}`` of one layer's decode cache, nested as the
    cache (a Mamba2 layer's ``conv``, a ``mamba_shared`` layer's ``mamba``
    and ``shared``); None for a cross-attention layer, which has none."""
    _check_kind(kind)
    if kind == "attn_bidir":
        raise ValueError("an encoder block has no decode cache")
    if kind == "xattn":
        return None
    if kind in ("mamba", "mamba_shared"):
        mc = cfg.mamba_cfg()
        w1 = mc.conv_width - 1
        mamba = {"conv": {"x": ((batch, w1, mc.d_inner), cfg.dtype),
                          "B": ((batch, w1, mc.d_state), cfg.dtype),
                          "C": ((batch, w1, mc.d_state), cfg.dtype)},
                 "ssm": ((batch, mc.n_heads, mc.head_dim, mc.d_state),
                         torch.float32)}
        if kind == "mamba":
            return mamba
        return {"mamba": mamba,
                "shared": block_cache_shapes("attn", cfg, batch, s_max)}
    if kind == "mlstm":
        xc = cfg.xlstm_cfg()
        h, pd = xc.n_heads, xc.head_dim
        return {"conv": ((batch, xc.conv_width - 1, xc.d_inner), cfg.dtype),
                "C": ((batch, h, pd, pd), torch.float32),
                "n": ((batch, h, pd), torch.float32),
                "m": ((batch, h), torch.float32)}
    if kind == "slstm":
        return {key: ((batch, cfg.d_model), torch.float32)
                for key in ("c", "n", "m", "y")}
    if kind == "mla":
        return {"kv_lat": ((batch, s_max, cfg.kv_lora_rank), cfg.dtype),
                "k_rope": ((batch, s_max, cfg.qk_rope_dim), cfg.dtype),
                "pos": ((s_max,), torch.int32)}
    s = min(cfg.window, s_max) if kind == "attn_local" else s_max
    kv = ((batch, cfg.n_kv, s, cfg.hd), cfg.dtype)
    return {"k": kv, "v": kv, "pos": ((s,), torch.int32)}


def block_cache_zeros(kind: str, cfg: ArchConfig, batch: int, s_max: int,
                      device=None) -> Optional[Dict[str, torch.Tensor]]:
    """Empty decode cache for one layer: zeros, every slot's position -1
    and an xLSTM state's m -1e30 (None for a cross-attention layer).
    Sliding-window layers get a ring of ``min(window, s_max)`` slots; a
    Mamba2 or xLSTM state is float32."""
    shapes = block_cache_shapes(kind, cfg, batch, s_max)
    if shapes is None:
        return None

    def zeros(tree):
        out = {n: zeros(v) if isinstance(v, dict) else
               torch.zeros(v[0], dtype=v[1], device=device)
               for n, v in tree.items()}
        if "pos" in out:
            out["pos"].fill_(-1)
        if "m" in out:
            out["m"].fill_(xlstm_mod.M_INIT)
        return out
    return zeros(shapes)


def image_context(cfg: ArchConfig, ctx: Optional[torch.Tensor],
                  batch: int) -> Optional[torch.Tensor]:
    """The image context in the model's type, checked: required (B, n,
    d_model) when ``cfg`` has cross-attention layers, ignored (as the
    reference ignores it, None) when it has none."""
    if "xattn" not in cfg.layer_kinds:
        return None
    if ctx is None:
        raise ValueError(f"{cfg.name} has cross-attention layers: pass "
                         f"ctx (B, n_ctx_tokens={cfg.n_ctx_tokens}, "
                         f"d_model={cfg.d_model})")
    if ctx.dim() != 3 or ctx.shape[0] != batch or \
            ctx.shape[2] != cfg.d_model:
        raise ValueError(f"ctx of shape {tuple(ctx.shape)} for batch "
                         f"{batch} and d_model {cfg.d_model}")
    return ctx.to(cfg.dtype)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A nested dict of tensors as a module, read as the reference reads
    its pytrees (``p["attn"]["wq"]``).  The tensors become parameters that
    need no gradient, for serving; a trainer turns gradients on with the
    model's ``requires_grad_()``."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, ParamTree(val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class LM(nn.Module):
    """The model: ``forward``, ``logits``, ``loss``, ``prefill``,
    ``init_cache``, ``decode_step``.

    Built on ``device`` (the current CUDA device when None, which raises
    without one; pass ``device="cpu"`` for the CPU) with weights drawn from
    ``generator`` (a ``torch.Generator`` on that device; seed 0 when None):
    truncated-normal fan-in weights, N(0, 0.02^2) embeddings, zero norm
    scales, as the reference.  On the CUDA device, attention runs the
    hand-written kernel.  A model with ``mamba_shared`` layers holds the
    shared attention block once, as ``shared_attn``; every such layer calls
    it.  The parameters need no gradient until ``requires_grad_()`` (the
    trainer's step builder calls it).  With gradients on, each GQA layer's
    attention goes through the kernel's ``torch.autograd.Function``: the
    forward kernel with its row statistics, and the backward kernels for
    dq, dk and dv (:mod:`repro_torch.kernels.flash_attention`), so every
    config trains on the card as far as it fits there (stablelm-1.6b at
    full width and depth on one 80 GB card); remat recomputes the forward
    kernel in the backward pass."""

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        for kind in cfg.layer_kinds:
            _check_kind(kind)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        gen, dt = generator, cfg.dtype
        self.embed = nn.Parameter(
            embed_init(gen, (cfg.vocab, cfg.d_model), dt, dev),
            requires_grad=False)
        self.final_norm = ParamTree(_norm_init(cfg, dt, dev))
        self.layers = nn.ModuleList(
            ParamTree(init_block(gen, kind, cfg, dev))
            for kind in cfg.layer_kinds)
        # zamba2's shared attention block, an ``attn`` block: one parameter
        # set for every mamba_shared layer (the reference's top-level
        # ``shared_attn``)
        self.shared_attn = (ParamTree(init_block(gen, "attn", cfg, dev))
                            if "mamba_shared" in cfg.pattern else None)
        if not cfg.tie_embed:
            self.lm_head = nn.Parameter(
                dense_init(gen, (cfg.vocab, cfg.d_model), 1, dt, dev),
                requires_grad=False)

    @property
    def device(self) -> torch.device:
        """The device the parameters lie on (it follows ``.to()``)."""
        return self.embed.device

    # ---- the reference's tree -----------------------------------------------
    def reference_leaf(self, name: str) -> Tuple[Tuple[str, ...],
                                                 Optional[int]]:
        """The reference's path of the parameter ``name`` (a key of
        ``named_parameters()``) and, for a layer of the repeated pattern,
        its repeat: layer ``len(prelude) + r * len(pattern) + i`` is repeat
        r of ``("stack", f"b{i}", ...)``, a prelude layer i is
        ``("prelude", f"p{i}", ...)``."""
        parts = tuple(name.split("."))
        if parts[0] != "layers":
            return parts, None
        cfg = self.cfg
        i, n_pre = int(parts[1]), len(cfg.prelude)
        if i < n_pre:
            return ("prelude", f"p{i}") + parts[2:], None
        r, j = divmod(i - n_pre, len(cfg.pattern))
        return ("stack", f"b{j}") + parts[2:], r

    def _reference_tree(self, leaf) -> Dict[str, Any]:
        """``leaf(name, ref_path, repeat)`` of every parameter, nested as
        the reference's tree (each stacked leaf once, from repeat 0)."""
        tree: Dict[str, Any] = {}
        for name, _ in self.named_parameters():
            path, r = self.reference_leaf(name)
            if r:
                continue
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf(name, path, r)
        return tree

    def param_shapes(self) -> Dict[str, Any]:
        """The reference's parameter shapes, nested as its tree: a leaf of
        the repeated pattern stacked over the repeats, ``(n_repeats,) +``
        the layer's shape."""
        params = dict(self.named_parameters())
        r = self.cfg.n_repeats
        return self._reference_tree(
            lambda name, path, rep: ((r,) if rep is not None else ()) +
            tuple(params[name].shape))

    def param_axes(self, params=None) -> Dict[str, Any]:
        """The reference's ``LM.param_axes``: the logical axes of every
        leaf, nested as the reference's tree, the stacked leaves with a
        leading ``layers`` axis.  With ``params`` (a tree of the
        reference's structure) the result is pruned to its leaves."""
        cfg = self.cfg
        kinds = {("prelude", f"p{i}"): k for i, k in enumerate(cfg.prelude)}
        kinds.update({("stack", f"b{i}"): k
                      for i, k in enumerate(cfg.pattern)})

        def axes(name, path, rep):
            if path[0] in ("embed", "lm_head"):
                return ("vocab", "embed")
            if path[0] == "final_norm":
                return _NORM_AXES[path[1]]
            if path[0] == "shared_attn":
                node, rest = block_axes("attn", cfg), path[1:]
            else:
                node, rest = block_axes(kinds[path[:2]], cfg), path[2:]
            for key in rest:
                node = node[key]
            return (("layers",) if rep is not None else ()) + tuple(node)

        tree = self._reference_tree(axes)
        if params is None:
            return tree

        def walk(ax_node, p_node):
            if isinstance(p_node, dict):
                return {k: walk(ax_node[k], v) for k, v in p_node.items()}
            return tuple(ax_node)
        return walk(tree, params)

    # ---- forward -----------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids through the embedding; float inputs (an audio model's
        frame embeddings) cast to the model's type, as they are."""
        cfg = self.cfg
        if tokens.is_floating_point():
            x = tokens.to(cfg.dtype)
        else:
            x = self.embed[tokens]
        if cfg.embed_scale:
            # the reference multiplies by a Python float, which JAX rounds
            # to the model's type first
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        return x

    def set_xattn_gates(self, value: float) -> int:
        """Set every cross-attention gate to ``value``; returns how many.
        The reference zero-initialises the gates, so at init ``tanh(0)``
        removes the cross-attention layers from the output; a check that
        must see those layers opens them first."""
        n = 0
        with torch.no_grad():
            for kind, p in zip(self.cfg.layer_kinds, self.layers):
                if kind == "xattn":
                    p["attn"]["gate"].fill_(value)
                    n += 1
        return n

    def forward(self, tokens: torch.Tensor,
                ctx: Optional[torch.Tensor] = None, return_aux: bool = False,
                moe_stats: Optional[Dict[str, Any]] = None,
                remat: bool = False):
        """Full-sequence pass: the final-normed hidden states (B, S, D) of
        token ids (B, S) or frame embeddings (B, S, d_model), with the
        image context ``ctx`` (B, n_ctx_tokens, d_model) of a model with
        cross-attention layers (required there, else ignored); with
        ``return_aux``, (hidden, the MoE aux loss, float32, summed as the
        reference sums it: the prelude's layers, then each pattern unit's
        sum).  (The reference also returns its decode caches; the port's
        prefill needs none.)  ``moe_stats``: see
        :func:`repro_torch.models.moe.moe_fwd`.  ``remat`` recomputes each
        pattern unit in the backward pass instead of keeping its
        activations (``torch.utils.checkpoint``, as the reference's
        ``jax.checkpoint(unit)``; the prelude is kept); it acts only where
        gradients are on."""
        cfg = self.cfg
        x = self._embed(tokens)
        ctx = image_context(self.cfg, ctx, x.shape[0])
        positions = torch.arange(x.shape[1], device=x.device)
        kinds = cfg.layer_kinds

        def run(x, lo: int, hi: int):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for i in range(lo, hi):
                x, a = block_fwd(kinds[i], self.layers[i], x, cfg,
                                 positions=positions, moe_stats=moe_stats,
                                 ctx=ctx, shared=self.shared_attn)
                aux = aux + a
            return x, aux

        n_pre, n_pat = len(cfg.prelude), len(cfg.pattern)
        x, aux_total = run(x, 0, n_pre)
        remat = remat and torch.is_grad_enabled()
        for lo in range(n_pre, len(kinds), n_pat):
            if remat:
                x, aux = torch.utils.checkpoint.checkpoint(
                    run, x, lo, lo + n_pat, use_reentrant=False)
            else:
                x, aux = run(x, lo, lo + n_pat)
            aux_total = aux_total + aux
        hidden = _apply_norm(self.final_norm, x, cfg)
        return (hidden, aux_total) if return_aux else hidden

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor,
             ctx: Optional[torch.Tensor] = None,
             remat: bool = True) -> torch.Tensor:
        """Mean token cross-entropy of ``labels`` (B, S) against the (tied)
        embedding, by :func:`.common.softmax_xent_chunked` with the final
        soft-cap, plus the MoE aux loss: the reference's ``LM.loss``.
        ``remat`` as :meth:`forward`."""
        cfg = self.cfg
        hidden, aux = self.forward(tokens, ctx, return_aux=True, remat=remat)
        emb = self.embed if cfg.tie_embed else self.lm_head
        return softmax_xent_chunked(hidden, emb, labels,
                                    softcap=cfg.final_softcap) + aux

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """float32 logits against the (tied) embedding, with the final
        soft-cap."""
        cfg = self.cfg
        emb = self.embed if cfg.tie_embed else self.lm_head
        lg = hidden.float() @ emb.float().t()
        if cfg.final_softcap:
            lg = cfg.final_softcap * torch.tanh(lg / cfg.final_softcap)
        return lg

    # ---- serving -----------------------------------------------------------
    def prefill(self, tokens: torch.Tensor,
                ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Last-position logits (B, 1, V) of the prompts (no cache, as the
        reference's lowered serving path); ``ctx`` as :meth:`forward`."""
        return self.logits(self.forward(tokens, ctx)[:, -1:])

    def init_cache(self, batch: int,
                   s_max: int) -> List[Optional[Dict[str, Any]]]:
        """Empty decode caches, one per layer, on the model's device (None
        for a cross-attention layer)."""
        return [block_cache_zeros(kind, self.cfg, batch, s_max, self.device)
                for kind in self.cfg.layer_kinds]

    def decode_step(self, token: torch.Tensor, pos: int, caches,
                    ctx: Optional[torch.Tensor] = None):
        """One-token decode.  token: (B, 1) integer (or (B, 1, d_model)
        features); pos: the absolute position (int); ``ctx`` as
        :meth:`forward`, the same at every step.  Returns (logits
        (B, 1, V) float32, caches), the caches updated in place."""
        cfg = self.cfg
        x = self._embed(token)
        ctx = image_context(self.cfg, ctx, x.shape[0])
        for i, (kind, p) in enumerate(zip(cfg.layer_kinds, self.layers)):
            x, caches[i] = block_decode(kind, p, x, caches[i], cfg, pos,
                                        ctx=ctx, shared=self.shared_attn)
        x = _apply_norm(self.final_norm, x, cfg)
        return self.logits(x), caches


# --------------------------------------------------------------------------
# weights from the reference
# --------------------------------------------------------------------------

def _tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as ``np.asarray`` gives them
    from JAX) as a CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree, prefix: str, out: Dict[str, Any]) -> None:
    for name, val in tree.items():
        key = f"{prefix}.{name}" if prefix else name
        if isinstance(val, dict):
            _flatten(val, key, out)
        else:
            out[key] = val


def load_reference_params(tree: Dict[str, Any], cfg: ArchConfig,
                          device: DeviceLike = None) -> LM:
    """The port's model holding the reference's parameters.

    ``tree`` is the JAX package's ``LM.init`` output as numpy arrays
    (``jax.tree.map(np.asarray, params)``).  The reference stacks each
    pattern position over the repeats: ``stack/b{i}/...[r]`` is layer
    ``len(prelude) + r * len(pattern) + i`` (for gemma2, repeat r runs b0,
    the local layer, then b1, the global one); ``prelude/p{i}`` is layer
    i.  Leaves are read by name, so MLA's (``attn.wq_a`` ...), the
    cross-attention's 0-d ``attn.gate`` (stacked to (R,), sliced back to
    0-d) and the Mamba2 leaves (``mamba.w_z`` ...) need nothing of their
    own; zamba2's top-level ``shared_attn`` fills the model's one
    ``shared_attn``.

    Every leaf keeps its own type (the MoE router, Mamba2's ``dt_bias``,
    ``a_log`` and ``d_skip``, and the xLSTM's ``w_if``, ``b_if``,
    ``r_heads`` and ``bias`` are float32 in a bf16 model, as the
    reference's), and must have the type of the port's parameter it
    fills."""
    dev = resolve_device(device)
    model = LM(cfg, device="meta")
    state: Dict[str, Any] = {}
    _flatten({k: v for k, v in tree.items()
              if k not in ("stack", "prelude")}, "", state)
    n_pre, n_pat = len(cfg.prelude), len(cfg.pattern)
    for i in range(n_pre):
        _flatten(tree["prelude"][f"p{i}"], f"layers.{i}", state)
    for i in range(n_pat):
        flat: Dict[str, Any] = {}
        _flatten(tree["stack"][f"b{i}"], "", flat)
        for r in range(cfg.n_repeats):
            layer = n_pre + r * n_pat + i
            for key, arr in flat.items():
                state[f"layers.{layer}.{key}"] = np.asarray(arr)[r]
    state = {k: _tensor(v) for k, v in state.items()}
    want = {k: t.dtype for k, t in model.state_dict().items()}
    wrong = {k: (str(t.dtype), str(want[k])) for k, t in state.items()
             if k in want and t.dtype != want[k]}
    if wrong:
        raise ValueError(f"{cfg.name}: leaves of another type than the "
                         f"model's (got, want): {wrong}")
    state = {k: t.to(dev) for k, t in state.items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model
