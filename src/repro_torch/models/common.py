"""Shared building blocks of the LM: the sharding rules, norms, rotary
embedding, init, the chunked cross-entropy (on one device and
vocab-parallel on a mesh).

Port of ``repro/models/common.py``.  :class:`ShardingRules` maps logical
axis names to the axes of a :class:`~repro_torch.launch.mesh.Mesh`, as the
reference's does; a partition spec is a plain tuple of entries (the
counterpart of ``jax.sharding.PartitionSpec``: a mesh axis name, a tuple
of them, or None for each dimension), and :class:`NamedSharding` pairs one
with its mesh.  Random init draws from an explicit ``torch.Generator``
with the reference's distributions; the bits differ from ``jax.random``'s,
so parity tests carry weights across with
:func:`repro_torch.models.lm.load_reference_params`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


# --------------------------------------------------------------------------
# sharding rules
# --------------------------------------------------------------------------

def P(*entries) -> tuple:
    """A partition spec: one entry per dimension (trailing ones may be
    left out), as ``jax.sharding.PartitionSpec(*entries)``."""
    return tuple(entries)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A partition spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: tuple


def axis_names(entry) -> tuple:
    """The mesh axes of one spec entry (none for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_slices(spec: Sequence, shape: Sequence[int], mesh,
                 coord: Sequence[int]) -> tuple:
    """The slice of each dimension of a ``shape`` tensor laid out by
    ``spec`` that the shard at mesh coordinate ``coord`` holds: a
    dimension over mesh axes is cut in equal contiguous blocks, the
    first of those axes major."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        idx, size = 0, 1
        for a in axis_names(entry):
            ax = mesh.axis_names.index(a)
            idx = idx * mesh.devices.shape[ax] + coord[ax]
            size *= mesh.devices.shape[ax]
        if n % size:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"split over {entry} ({size} shards)")
        out.append(slice(idx * (n // size), (idx + 1) * (n // size)))
    return tuple(out)


@dataclasses.dataclass
class ShardingRules:
    """logical axis -> mesh axis (or None).  Missing names -> replicated."""
    mesh: Any = None
    rules: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def _axis_size(self, mapped) -> int:
        size = 1
        for n in axis_names(mapped):
            size *= self.mesh.shape[n]
        return size

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> tuple:
        """The partition spec of the logical axes.  With ``shape``, an axis
        whose dimension does not divide by its mesh axes' size is dropped
        (replicated): 40 MLA heads on a 16-way model axis, or a length-1
        decode axis."""
        if self.mesh is None:
            return P()
        axes = []
        for i, name in enumerate(logical_axes):
            mapped = self.rules.get(name) if name else None
            if mapped is not None and shape is not None:
                if shape[i] % self._axis_size(mapped) != 0:
                    mapped = None
            axes.append(mapped)
        return P(*axes)

    def shard(self, parts: List[torch.Tensor],
              logical_axes: Sequence[Optional[str]],
              shape: Sequence[int]) -> List[torch.Tensor]:
        """Check that ``parts``, one per shard in mesh order, are the
        pieces of a ``shape`` tensor laid out as ``spec(logical_axes,
        shape)`` says, and return them.  Moves no data (the reference's
        ``with_sharding_constraint`` may move it; the port lays its
        tensors out where they are made).  No-op without a mesh."""
        if self.mesh is None:
            return parts
        spec = self.spec(logical_axes, shape)
        coords = list(np.ndindex(*self.mesh.devices.shape))
        if len(parts) != len(coords):
            raise ValueError(f"{len(parts)} parts for a mesh of "
                             f"{len(coords)} shards")
        for coord, t in zip(coords, parts):
            want = tuple(s.stop - s.start for s in
                         local_slices(spec, shape, self.mesh, coord))
            if tuple(t.shape) != want:
                raise ValueError(f"a part of shape {tuple(t.shape)} where "
                                 f"{spec} of {tuple(shape)} holds {want}")
        return parts

    def named_sharding(self, logical_axes: Sequence[Optional[str]],
                       shape: Optional[Sequence[int]] = None):
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(logical_axes, shape))


# --------------------------------------------------------------------------
# initialisation
# --------------------------------------------------------------------------

def dense_init(gen: Optional[torch.Generator], shape: Sequence[int],
               in_axis: int = 0, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut to [-2, 2], times
    1/sqrt(shape[in_axis]); drawn in float32, then cast."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (1.0 / math.sqrt(shape[in_axis]))).to(dtype)


def embed_init(gen: Optional[torch.Generator], shape: Sequence[int],
               dtype=torch.float32, device=None) -> torch.Tensor:
    """N(0, 0.02^2), drawn in float32, then cast."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    t.normal_(0.0, 1.0, generator=gen)
    return (t * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             mean_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + scale`` (a zero-init scale is
    the identity), returned in x's type.  ``mean_sq``: the float32 mean of
    squares over the last dimension, where x holds only a slice of it (a
    model shard's channels), else computed from x."""
    xf = x.float()
    var = (xf.square().mean(dim=-1, keepdim=True) if mean_sq is None
           else mean_sq)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, D even); positions: (S,).  The half-split layout (first
    half rotated against the second).  As in the reference, the
    frequencies are cast to x's type before the angle is taken, so in
    bfloat16 they are bfloat16-rounded; the angle, cos and sin are float32,
    and cos and sin are cast to x's type."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(d, theta), dtype=x.dtype,
                            device=x.device)
    ang = positions[..., :, None].float() * freqs[None, :]
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def _chunk(s: int, chunk: int) -> int:
    """The chunk length: ``chunk``, or the whole sequence when it does not
    divide S."""
    return chunk if s % chunk == 0 else s


def softmax_xent_chunked(x: torch.Tensor, emb: torch.Tensor,
                         labels: torch.Tensor, chunk: int = 512,
                         softcap: float = 0.0) -> torch.Tensor:
    """:func:`softmax_xent_sum` divided by B * S: the mean cross-entropy
    (the reference's ``softmax_xent_chunked``)."""
    b, s, _ = x.shape
    return softmax_xent_sum(x, emb, labels, chunk, softcap) / (b * s)


def softmax_xent_sum(x: torch.Tensor, emb: torch.Tensor,
                     labels: torch.Tensor, chunk: int = 512,
                     softcap: float = 0.0) -> torch.Tensor:
    """Summed cross-entropy of ``labels`` (B, S) under the logits ``x @
    emb^T``, with the unembedding fused per sequence chunk of ``chunk``
    (the whole sequence when S % chunk != 0), so the full (B, S, V) logits
    never exist at once.  Logits are float32 from float32-cast inputs,
    soft-capped by ``softcap`` (gemma2's final cap) when it is nonzero;
    the row max is held constant for the gradient (the reference's
    ``stop_gradient``).  Returns the float32 sum over the chunks."""
    s = x.shape[1]
    chunk = _chunk(s, chunk)
    embf = emb.float()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        logits = x[:, c0:c0 + chunk].float() @ embf.t()
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        m = logits.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
        gold = logits.gather(
            -1, labels[:, c0:c0 + chunk, None].long())[..., 0]
        total = total + (lse - gold).sum()
    return total


def softmax_xent_sum_mesh(xs: List[torch.Tensor], embs: List[torch.Tensor],
                          labels: List[torch.Tensor], rows, comm,
                          group: Sequence[int], chunk: int = 512,
                          softcap: float = 0.0) -> torch.Tensor:
    """:func:`softmax_xent_chunked`'s sum (not yet divided by B * S) for
    one data replica, vocab-parallel over its model shards ``group``:
    member ``j`` holds the replica's hidden states ``xs[j]`` (B, S, D),
    its rows ``rows[j] = (lo, hi)`` of the (tied) embedding ``embs[j]``
    and the labels ``labels[j]`` (B, S).  Per chunk, each member makes
    the float32 logits of its rows; the row max (held constant for the
    gradient), the sum of exponentials and the gold logit (taken by the
    member that owns the label's row, zero elsewhere) are combined over
    the group; the log-sum-exp and the sum are the first member's.
    Returns a float32 scalar on the first member's device.  Where every
    member holds the whole vocabulary (a vocab that does not divide the
    model axis), the first member computes the loss alone."""
    if all(r == (0, embs[0].shape[0]) for r in rows):
        return softmax_xent_sum(xs[0], embs[0], labels[0], chunk, softcap)
    s = xs[0].shape[1]
    chunk = _chunk(s, chunk)
    embf = [e.float() for e in embs]
    total = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    for c0 in range(0, s, chunk):
        logits = []
        for x, e in zip(xs, embf):
            lg = x[:, c0:c0 + chunk].float() @ e.t()
            if softcap:
                lg = softcap * torch.tanh(lg / softcap)
            logits.append(lg)
        m = comm.all_max([lg.amax(dim=-1, keepdim=True) for lg in logits],
                         group, "loss")
        parts = []
        for lg, mj, lab, (lo, hi) in zip(logits, m, labels, rows):
            lab = lab[:, c0:c0 + chunk].long() - lo
            mine = (lab >= 0) & (lab < hi - lo)
            gold = lg.gather(-1, lab.clamp(0, hi - lo - 1)[..., None])[..., 0]
            parts.append(torch.stack([torch.exp(lg - mj).sum(dim=-1),
                                      torch.where(mine, gold, 0.0)]))
        sums = comm.all_reduce(parts, group, "loss")[0]
        lse = torch.log(sums[0]) + m[0][..., 0]
        total = total + (lse - sums[1]).sum()
    return total
