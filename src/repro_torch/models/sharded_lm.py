"""The LM on a mesh: tensor parallel over ``model``, data parallel over
``data`` (and ``pod``), in one process.

Port of what the reference's ``LM`` does under GSPMD with
``make_lm_rules(mesh)``, for the dense GQA blocks (``attn``,
``attn_local``, ``attn_global``, ``attn_bidir``), MLA (``mla``), gated
cross-attention (``xattn``) and Mamba2 with zamba2's shared attention
block (``mamba``, ``mamba_shared``).  :class:`ShardedLM` holds each
shard's slices of the parameters as tensors of its own on its device
(:func:`repro_torch.distributed.sharding.leaf_layouts`: the reference's
specs, one tensor per layer); a mesh may repeat a device.  A step is one
autograd graph over the shards, the collectives of
:mod:`repro_torch.distributed.collectives` its only links:

* the global batch is split in contiguous row blocks over the data
  replicas, as a ``NamedSharding`` over ``("pod", "data")`` splits it,
  and so is a VLM's image context ``ctx``, replicated over each
  replica's model shards;
* the embedding lookup is vocab-parallel: each model shard looks up the
  tokens in its rows of the ``("vocab", "embed")`` table and the partial
  rows are all-reduced (a tied table's gradient sums the lookup's part and
  the loss's);
* the residual stream is replicated: each model shard holds its copy;
* attention is head parallel.  GQA splits ``wq``/``wk``/``wv`` by column
  and ``wo`` by row, each shard running the ``flash_attention`` kernel
  (forward, and on the backward pass its backward kernels) on its heads;
  MLA projects both latents from its replicated ``wq_a``/``wkv_a``, then
  its columns of ``wq_b``/``wkv_b``, and attends its heads in float32 in
  plain ops (:func:`.attention.mla_fwd_mesh`); cross-attention projects
  q from the text rows and k, v from the context by its columns and
  attends its heads by the plain ``_sdpa``
  (:func:`.attention.cross_fwd_mesh`, the ``tanh(gate)`` after the sum).
  Each ends with an all-reduce of the ``wo`` partials; the FFN splits
  ``w_gate``/``w_up`` by column and ``w_down`` by row, then an
  all-reduce;
* Mamba2 is head parallel over the ``inner`` channels
  (:func:`.mamba2.mamba2_fwd_mesh`): each shard projects its columns of
  ``w_z``/``w_x``, convolves its channels, computes B, C and dt whole from
  the replicated leaves, runs the chunked SSD on its heads, and the
  gated norm's sums of squares and the ``out_proj`` partials are
  all-reduced.  zamba2's shared attention block
  (one parameter set, ``shared_attn``) is an ``attn`` block on the mesh,
  GQA and FFN split as above; every ``mamba_shared`` layer calls each
  shard's slices of it, so autograd sums its gradient over the call
  sites before the optimizer sums it over the shards that hold it;
* with ``cfg.seq_parallel`` (the reference's sequence parallelism: every
  block weight replicated) each model shard of an ``mla`` block computes
  its contiguous block of S / M query rows, the attention against the
  keys of all rows before them and the FFN of its rows, and the rows are
  regathered (:meth:`MeshComm.regather`, whose backward is the
  adjoint); the other kinds compute replicated, as the reference's GQA
  and cross-attention read no such field.  No shipped config sets
  ``seq_parallel``: this path runs only in the CPU tests, never yet on
  a card;
* the loss is the vocab-parallel chunked cross-entropy
  (:func:`.common.softmax_xent_sum_mesh`), summed over the replicas and
  divided by the global B * S.

A dimension that does not divide its mesh axis is replicated, as the
reference's rules fall back: every shard then holds it whole and computes
with it (a vocab of 504 rows on a model axis of 4, a flat ``kv_x_dim``
that splits inside a head).  Where a split block ends inside a head
(reduced minicpm3's 96 ``wq_b`` columns on a model axis of 8), a shard
attends every head its rows of ``wo`` touch, whole.  The bf16 partial
sums of the all-reduces are summed in float32 and rounded once to bf16.
A Mamba2 block that would split inside an SSD head raises.  The other
block kinds do not run on a mesh yet: MoE and its dense blocks (``moe``,
``dense``; ROADMAP A3.4.1, expert parallel) and xLSTM (``mlstm``,
``slstm``; the xLSTM half of A3.4.3).  A model of them raises here, and
their parameter layouts
(:func:`~repro_torch.distributed.sharding.param_shardings`) are ported.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint

from ..distributed.collectives import MeshComm
from ..distributed.sharding import (gather_tree, leaf_layouts,
                                    make_lm_rules, split_tree)
from . import attention as attn_mod
from . import ffn as ffn_mod
from . import mamba2 as mamba_mod
from .common import softmax_xent_sum_mesh
from .lm import LM, ParamTree, _apply_norm, image_context

#: the block kinds that run on a mesh
MESH_KINDS = ("attn", "attn_local", "attn_global", "attn_bidir", "mla",
              "xattn", "mamba", "mamba_shared")
#: the kinds whose blocks are Mamba2 (a ``mamba_shared`` block then calls
#: the shared attention block)
MAMBA_KINDS = ("mamba", "mamba_shared")


def _nest(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, t in flat.items():
        node = out
        *head, last = name.split(".")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = t
    return out


class ShardedLM:
    """``model``'s parameters split over ``mesh`` (a mesh of axes (data,
    model) or (pod, data, model), :mod:`repro_torch.launch.mesh`), with
    the forward pass, the loss and prefill on it.

    Shard ``k`` (``mesh.devices.flat[k]``) is model index ``k % M`` of
    data replica ``k // M``; ``shards[k]`` is its :class:`ParamTree`, named
    as ``model.named_parameters()``.  The parameters need no gradient
    until ``requires_grad_()``.  :meth:`gather` gives the full parameters
    back bit for bit."""

    def __init__(self, model: LM, mesh):
        cfg = model.cfg
        other = sorted(set(cfg.layer_kinds) - set(MESH_KINDS))
        if other:
            raise ValueError(
                f"{cfg.name}: block kinds {other} do not run on a mesh yet "
                "(ROADMAP A3.4.1, expert-parallel MoE for moe and dense; "
                "A3.4.3, the xLSTM inner sharding for mlstm and slstm); on "
                f"a mesh the port runs {MESH_KINDS}")
        self.cfg, self.mesh = cfg, mesh
        self.rules = make_lm_rules(mesh)
        self.comm = MeshComm(mesh)
        self.layouts = leaf_layouts(model, self.rules)
        n_model = self.comm.n_model

        def split(name):
            return self.layouts[name].model_dim is not None

        # each kind's shard plans and FFN split, from its first layer (the
        # layers of a kind have one shape, so one layout), by what the kind
        # holds; zamba2's shared block under the key "shared_attn"
        self.attn_plans: Dict[str, list] = {}
        self.ffn_split: Dict[str, bool] = {}
        self.mamba_plans: Optional[list] = None
        for i, kind in enumerate(cfg.layer_kinds):
            if kind in MAMBA_KINDS:
                if self.mamba_plans is None:
                    self.mamba_plans = mamba_mod.mamba_mesh_plan(
                        cfg.mamba_cfg(), n_model,
                        split(f"layers.{i}.mamba.w_x"))
                continue
            if kind in self.attn_plans:
                continue
            at = f"layers.{i}.attn"
            if kind == "mla":
                self.attn_plans[kind] = attn_mod.mla_mesh_plan(
                    cfg.mla_cfg(), n_model, split(f"{at}.wq_b"),
                    split(f"{at}.wkv_b"), split(f"{at}.wo"))
            else:
                self.attn_plans[kind] = attn_mod.gqa_mesh_plan(
                    cfg.attn_cfg("attn"), n_model, split(f"{at}.wq"),
                    split(f"{at}.wk"))
            self.ffn_split[kind] = split(f"layers.{i}.ffn.w_up")
        if "mamba_shared" in cfg.layer_kinds:
            self.attn_plans["shared_attn"] = attn_mod.gqa_mesh_plan(
                cfg.attn_cfg("attn"), n_model, split("shared_attn.attn.wq"),
                split("shared_attn.attn.wk"))
            self.ffn_split["shared_attn"] = split("shared_attn.ffn.w_up")
        params = {n: p.detach() for n, p in model.named_parameters()}
        parts = split_tree(params, self.specs, mesh)
        self.shards = [ParamTree(_nest(part)) for part in parts]
        self._head = "embed" if cfg.tie_embed else "lm_head"
        v = cfg.vocab // n_model if split(self._head) else cfg.vocab
        self.vocab_rows = [(m * v, (m + 1) * v) if split(self._head)
                           else (0, cfg.vocab) for m in range(n_model)]

    @property
    def device(self) -> torch.device:
        """The first shard's device: where the loss and the metrics are."""
        return self.comm.devices[0]

    @property
    def specs(self) -> Dict[str, tuple]:
        return {n: lay.spec for n, lay in self.layouts.items()}

    # ---- parameters ---------------------------------------------------------
    def parameters(self):
        for tree in self.shards:
            yield from tree.parameters()

    def shard_param(self, k: int, name: str) -> torch.nn.Parameter:
        return self.shards[k].get_parameter(name)

    def requires_grad_(self, flag: bool = True) -> "ShardedLM":
        for p in self.parameters():
            p.requires_grad_(flag)
        return self

    def gather(self, device: Any = "cpu") -> Dict[str, torch.Tensor]:
        """The full parameters, by name, on ``device``."""
        parts = [{n: p.detach() for n, p in tree.named_parameters()}
                 for tree in self.shards]
        shapes = {n: lay.shape for n, lay in self.layouts.items()}
        return gather_tree(parts, self.specs, shapes, self.mesh, device)

    def load_(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy full parameters (by name, on any device) into the shards."""
        parts = split_tree(params, self.specs, self.mesh)
        with torch.no_grad():
            for tree, part in zip(self.shards, parts):
                for name, t in part.items():
                    tree.get_parameter(name).copy_(t)

    # ---- forward ------------------------------------------------------------
    def _place(self, t: torch.Tensor, rep: int) -> List[torch.Tensor]:
        """Replica ``rep``'s rows of the global batch ``t``, on each of its
        model shards' devices."""
        n_rep = self.comm.n_rep
        if t.shape[0] % n_rep:
            raise ValueError(f"a global batch of {t.shape[0]} does not split "
                             f"over {n_rep} data replicas")
        b = t.shape[0] // n_rep
        rows = t[rep * b:(rep + 1) * b]
        return [rows.to(self.comm.devices[k])
                for k in self.comm.model_group(rep)]

    def _embed(self, ps, group, tokens: List[torch.Tensor]):
        cfg = self.cfg
        if tokens[0].is_floating_point():
            xs = [t.to(cfg.dtype) for t in tokens]
        else:
            xs = []
            for p, tok, (lo, hi) in zip(ps, tokens, self.vocab_rows):
                if (lo, hi) == (0, cfg.vocab):
                    xs.append(p["embed"][tok])
                    continue
                idx = tok.long() - lo
                mine = (idx >= 0) & (idx < hi - lo)
                rows = p["embed"][idx.clamp(0, hi - lo - 1)]
                xs.append(torch.where(mine[..., None], rows,
                                      rows.new_zeros(())))
            if self.vocab_rows[0] != (0, cfg.vocab):
                xs = self.comm.all_reduce(xs, group, "embed")
        if cfg.embed_scale:
            xs = [x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
                  for x in xs]
        return xs

    def _block(self, kind: str, ps, xs, group, positions, ctxs,
               shared=None):
        """Layer ``kind`` of one data replica: ``ps`` its members' slices
        of the layer, ``xs`` their copies of the residual stream;
        ``shared``: their slices of zamba2's shared attention block (read
        by ``mamba_shared`` alone)."""
        cfg, comm = self.cfg, self.comm
        if kind in MAMBA_KINDS:
            hs = [_apply_norm(p["ln1"], x, cfg) for p, x in zip(ps, xs)]
            m = mamba_mod.mamba2_fwd_mesh([p["mamba"] for p in ps], hs,
                                          cfg.mamba_cfg(), self.mamba_plans,
                                          comm, group)
            xs = [x + t for x, t in zip(xs, m)]
            if kind == "mamba_shared":  # the shared block is an attn block
                xs = self._attn_block("attn", "shared_attn", shared, xs,
                                      group, positions, ctxs)
            return xs
        if kind == "mla" and cfg.seq_parallel:
            return self._mla_rows(ps, xs, group, positions)
        return self._attn_block(kind, kind, ps, xs, group, positions, ctxs)

    def _attn_block(self, kind: str, key: str, ps, xs, group, positions,
                    ctxs):
        """An attention block (its attention, then its FFN) of kind
        ``kind``, its shard plans and FFN split under ``key``."""
        cfg, comm = self.cfg, self.comm
        hs = [_apply_norm(p["ln1"], x, cfg) for p, x in zip(ps, xs)]
        attn, plans = [p["attn"] for p in ps], self.attn_plans[key]
        if kind == "mla":
            a = attn_mod.mla_fwd_mesh(attn, hs, cfg.mla_cfg(), plans, comm,
                                      group, positions)
        elif kind == "xattn":
            a = attn_mod.cross_fwd_mesh(attn, hs, ctxs, cfg.attn_cfg(kind),
                                        plans, comm, group)
        else:
            a = attn_mod.gqa_fwd_mesh(attn, hs, cfg.attn_cfg(kind), plans,
                                      comm, group, positions)
        if "post_ln1" in ps[0]:
            a = [_apply_norm(p["post_ln1"], t, cfg) for p, t in zip(ps, a)]
        xs = [x + t for x, t in zip(xs, a)]
        hs = [_apply_norm(p["ln2"], x, cfg) for p, x in zip(ps, xs)]
        f = ffn_mod.ffn_fwd_mesh([p["ffn"] for p in ps], hs, cfg.ffn_cfg(),
                                 self.ffn_split[key], comm, group)
        if "post_ln2" in ps[0]:
            f = [_apply_norm(p["post_ln2"], t, cfg) for p, t in zip(ps, f)]
        return [x + t for x, t in zip(xs, f)]

    def _mla_rows(self, ps, xs, group, positions):
        """A sequence-parallel ``mla`` block (its weights replicated):
        member ``j`` of the M in ``group`` computes the rows j * S / M ..
        (j + 1) * S / M of the block's output, the attention of those
        query rows against the keys of every row up to its last, then the
        FFN of its rows; the blocks of rows are regathered."""
        cfg = self.cfg
        s, m = xs[0].shape[1], len(group)
        if s % m:
            raise ValueError(f"a sequence of {s} does not split over {m} "
                             "model shards (seq_parallel)")
        own = [(j * s // m, (j + 1) * s // m) for j in range(m)]
        outs = []
        for p, x, pos, (r0, r1) in zip(ps, xs, positions, own):
            h = _apply_norm(p["ln1"], x[:, :r1], cfg)
            y = x[:, r0:r1] + attn_mod.mla_fwd(p["attn"], h, cfg.mla_cfg(),
                                                positions=pos[:r1],
                                                rows=(r0, r1))
            h = _apply_norm(p["ln2"], y, cfg)
            outs.append(y + ffn_mod.ffn_fwd(p["ffn"], h, cfg.ffn_cfg()))
        return self.comm.regather(outs, group, own, [(0, s)] * m, 1, "seq")

    def _replica(self, rep: int, tokens: List[torch.Tensor],
                 ctxs: Optional[List[torch.Tensor]],
                 remat: bool) -> List[torch.Tensor]:
        cfg = self.cfg
        group = self.comm.model_group(rep)
        ps = [self.shards[k] for k in group]
        layers = [p["layers"] for p in ps]
        shared = ([p["shared_attn"] for p in ps] if "shared_attn" in ps[0]
                  else None)
        s = tokens[0].shape[1]
        positions = [torch.arange(s, device=self.comm.devices[k])
                     for k in group]
        kinds = cfg.layer_kinds

        def run(xs, lo: int, hi: int):
            for i in range(lo, hi):
                xs = self._block(kinds[i], [t[str(i)] for t in layers], xs,
                                 group, positions, ctxs, shared)
            return xs

        xs = self._embed(ps, group, tokens)
        n_pre, n_pat = len(cfg.prelude), len(cfg.pattern)
        remat = remat and torch.is_grad_enabled()
        if remat and n_pre:
            xs = torch.utils.checkpoint.checkpoint(run, xs, 0, n_pre,
                                                   use_reentrant=False)
        else:
            xs = run(xs, 0, n_pre)
        for lo in range(n_pre, len(kinds), n_pat):
            if remat:
                xs = torch.utils.checkpoint.checkpoint(
                    run, xs, lo, lo + n_pat, use_reentrant=False)
            else:
                xs = run(xs, lo, lo + n_pat)
        return [_apply_norm(p["final_norm"], x, cfg) for p, x in zip(ps, xs)]

    def _ctx(self, ctx: Optional[torch.Tensor], batch: int):
        """The image context checked as :meth:`LM.forward` checks it
        (required by a model with cross-attention layers); a model without
        them takes none."""
        if ctx is not None and "xattn" not in self.cfg.layer_kinds:
            raise ValueError(f"{self.cfg.name} has no cross-attention "
                             "layers: it takes no image context")
        return image_context(self.cfg, ctx, batch)

    def forward(self, tokens: torch.Tensor,
                ctx: Optional[torch.Tensor] = None, remat: bool = False
                ) -> List[torch.Tensor]:
        """The final-normed hidden states of the global batch ``tokens``
        (B, S) ids, or (B, S, d_model) frames for an audio model, with the
        image context ``ctx`` (B, n_ctx_tokens, d_model) of a model with
        cross-attention layers (required there, refused elsewhere): one
        (B / data replicas, S, d_model) tensor per shard, in mesh order
        (each replica's rows, replicated over its model shards).  ``remat``
        recomputes each pattern unit in the backward pass
        (``torch.utils.checkpoint``, as :meth:`LM.forward`), and the
        prelude as one more such segment: unlike :meth:`LM.forward`, which
        keeps it, since zamba2's three prelude Mamba2 layers would keep
        their SSD decay tensors on every shard through the step."""
        ctx = self._ctx(ctx, tokens.shape[0])
        hidden = []
        for rep in range(self.comm.n_rep):
            ctxs = None if ctx is None else self._place(ctx, rep)
            hidden += self._replica(rep, self._place(tokens, rep), ctxs,
                                    remat)
        shape = (tokens.shape[0], tokens.shape[1], self.cfg.d_model)
        return self.rules.shard(hidden, ("batch", None, "embed"), shape)

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor,
             ctx: Optional[torch.Tensor] = None,
             remat: bool = True) -> torch.Tensor:
        """:meth:`LM.loss` of the global batch on the mesh: the mean token
        cross-entropy, a float32 scalar on the first shard's device;
        ``ctx`` as :meth:`forward`."""
        cfg, comm = self.cfg, self.comm
        hidden = self.forward(tokens, ctx, remat)
        total = None
        for rep in range(comm.n_rep):
            group = comm.model_group(rep)
            part = softmax_xent_sum_mesh(
                [hidden[k] for k in group],
                [self.shards[k][self._head] for k in group],
                self._place(labels, rep), self.vocab_rows, comm, group,
                softcap=cfg.final_softcap)
            if group[0] != 0:
                part = comm.move(part, group[0], 0, "loss")
            total = part if total is None else total + part
        return total / (labels.shape[0] * labels.shape[1])

    def prefill(self, tokens: torch.Tensor,
                ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Last-position float32 logits (B, 1, V) of the global batch, on
        the first shard's device; ``ctx`` as :meth:`forward`."""
        cfg, comm = self.cfg, self.comm
        hidden = self.forward(tokens, ctx)
        rows = []
        for rep in range(comm.n_rep):
            group = comm.model_group(rep)
            parts = []
            for k in group[:1] if self.vocab_rows[0] == (0, cfg.vocab) \
                    else group:
                lg = hidden[k][:, -1:].float() @ \
                    self.shards[k][self._head].float().t()
                if cfg.final_softcap:
                    lg = cfg.final_softcap * torch.tanh(lg / cfg.final_softcap)
                parts.append(lg if k == 0 else
                             comm.move(lg, k, 0, "logits"))
            rows.append(torch.cat(parts, dim=2))
        return torch.cat(rows, dim=0)
