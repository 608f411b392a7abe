"""Mixture-of-Experts FFN (deepseek-moe-16b, moonshot-v1-16b-a3b).

Port of ``repro/models/moe.py`` for one device.  Fine-grained MoE:
``n_experts`` routed experts with top-``k`` softmax routing, optional
always-on shared experts (DeepSeek-MoE's 2 shared), and the Switch
load-balance auxiliary loss.

Dispatch is gather/scatter based with a capacity per expert, as in the
reference, whose choices the port keeps so that the same assignments are
kept and dropped:

* router logits in float32, softmax, top-k with ties to the lower expert
  index (``lax.top_k``'s rule; a stable descending sort here, since
  ``torch.topk`` promises no order among equal values), the gates
  renormalised with ``+ 1e-9``;
* capacity ``max(int(capacity_factor * T * k / E + 1), min(T, 64))``: the
  reference's chunk count ``g`` is 1 without a mesh;
* each assignment's rank within its expert by a stable sort of the flat,
  token-major assignments (or by the one-hot cumulative sum when
  ``FLAGS["moe_onehot_dispatch"]`` is set: the same ranks); an assignment
  ranked at or past the capacity is dropped;
* the expert FFNs on the (E, C, D) buffers by batched matrix products.

The combine is deterministic: the reference scatter-adds every slot's
gated output into its token in slot order (expert-major), in the model's
type.  The port gathers each token's k slot outputs through its slot
indices sorted ascending and adds them in that order, so a token's sum is
the reference's sum, and no float atomics run on the card: a repeated
prefill gives the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import dense_init
from .ffn import FFNConfig, ffn_fwd, init_ffn
from .perf import FLAGS

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_expert: int                   # per-expert FFN hidden size (1408)
    n_experts: int = 64
    top_k: int = 6
    n_shared: int = 0               # deepseek: 2 always-on shared experts
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    activation: str = "silu"

    @property
    def shared_cfg(self) -> Optional[FFNConfig]:
        if self.n_shared == 0:
            return None
        return FFNConfig(self.d_model, self.n_shared * self.d_expert,
                         self.activation, gated=True)


def _trunc_normal(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def init_moe(gen: Optional[torch.Generator], cfg: MoEConfig,
             dtype=torch.bfloat16, device=None) -> Params:
    """The router float32 (fan-in truncated normal), the experts'
    truncated-normal(-2, 2) weights times 1/sqrt(d) (gate, up) and
    1/sqrt(f) (down) in ``dtype``, and the shared experts' gated FFN."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert
    p = {
        "router": dense_init(gen, (d, e), 0, torch.float32, device),
        "w_gate": _trunc_normal(gen, (e, d, f), 1.0 / d ** 0.5, dtype,
                                device),
        "w_up": _trunc_normal(gen, (e, d, f), 1.0 / d ** 0.5, dtype, device),
        "w_down": _trunc_normal(gen, (e, f, d), 1.0 / f ** 0.5, dtype,
                                device),
    }
    if cfg.n_shared:
        p["shared"] = init_ffn(gen, cfg.shared_cfg, dtype, device)
    return p


#: the reference's logical axes of the MoE leaves (``MOE_AXES``)
MOE_AXES = {
    "router": ("embed", None),
    "w_gate": ("expert", "embed", None),
    "w_up": ("expert", "embed", None),
    "w_down": ("expert", None, "embed"),
    "shared": {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
               "w_down": ("mlp", "embed")},
}


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    # the reference's jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if name == "silu" else F.gelu(x, approximate="tanh")


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest, in descending
    order, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _counts(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Assignments per expert.  (``torch.bincount`` would wait for the
    device to size its output; integer adds give the same counts in any
    order.)"""
    return torch.zeros(e, dtype=torch.long, device=flat_e.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))


def _rank_in_expert(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Rank of each assignment within its expert, in the order of
    ``flat_e``: by a stable sort, or by the one-hot cumulative sum under
    ``FLAGS["moe_onehot_dispatch"]``."""
    if FLAGS.get("moe_onehot_dispatch"):
        pos = torch.cumsum(F.one_hot(flat_e, e), dim=0) - 1
        return pos.gather(1, flat_e[:, None])[:, 0]
    sorted_e, order = torch.sort(flat_e, stable=True)
    counts = _counts(flat_e, e)
    seg_start = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(flat_e.numel(), device=flat_e.device) \
        - seg_start[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    return rank


def capacity(cfg: MoEConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens on one device."""
    return max(int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts + 1),
               min(t, 64))


def moe_fwd(p, x: torch.Tensor, cfg: MoEConfig,
            stats: Optional[Dict[str, Any]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, aux_loss).  x: (B, S, D); aux a float32 scalar.

    ``stats``, when a dict, gets the call's assignment and drop counts
    added to its ``"assignments"`` and ``"dropped"`` entries (tensors on
    x's device; nothing waits for the device)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    xt = x.reshape(t, d)

    logits = xt.float() @ p["router"]                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)                 # (T, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # load-balance aux loss (Switch): E * sum_e density_e * mean-prob_e
    flat_e = expert_idx.reshape(-1)                          # (T k,)
    density = _counts(flat_e, e).float() * (1.0 / (t * k))
    aux = cfg.aux_coef * e * torch.sum(density * probs.mean(0))

    # dispatch: slot e * cap + rank, or the overflow slot e * cap
    pos_in_e = _rank_in_expert(flat_e, e)
    kept = pos_in_e < cap
    slot = torch.where(kept, flat_e * cap + pos_in_e,
                       torch.full_like(flat_e, e * cap))
    if stats is not None:
        stats["assignments"] = stats.get("assignments", 0) + flat_e.numel()
        stats["dropped"] = stats.get("dropped", 0) + (~kept).sum()
    token_of = torch.arange(t, device=x.device).repeat_interleave(k)
    # the overflow slot takes every dropped write and is cut off; an
    # unused slot holds token 0 (the reference zeroes it, since its
    # scatter-add reads every slot; the combine below never reads one)
    buf_tok = torch.zeros(e * cap + 1, dtype=torch.long, device=x.device)
    buf_tok[slot] = token_of
    slot_gate = torch.zeros(e * cap + 1, dtype=torch.float32,
                            device=x.device)
    slot_gate[slot] = gate_vals.reshape(-1)
    xd = xt[buf_tok[:-1]].view(e, cap, d)

    # batched expert FFN
    h = _act(torch.bmm(xd, p["w_gate"]), cfg.activation) \
        * torch.bmm(xd, p["w_up"])
    yd = torch.bmm(h, p["w_down"])                           # (E, C, D)
    weighted = yd.view(e * cap, d) * slot_gate[:-1, None].to(yd.dtype)

    # combine: each token's slots in ascending order, added one by one
    # from the first (a dropped assignment reads the zero row at e * cap)
    rows = torch.cat([weighted, weighted.new_zeros((1, d))])
    order = torch.sort(slot.view(t, k), dim=1).values
    out = rows[order[:, 0]]
    for j in range(1, k):
        out = out + rows[order[:, j]]

    if cfg.n_shared:
        out = out + ffn_fwd(p["shared"], xt[None], cfg.shared_cfg)[0]
    return out.view(b, s, d).to(x.dtype), aux
