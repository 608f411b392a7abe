"""TV regularisation on one device (paper SS2.3).

Port of the single-device half of ``repro/core/regularization.py``
(lines 52-137).  Two minimisers, as in TIGRE:

* :func:`minimize_tv` -- steepest-descent minimisation of smoothed
  isotropic TV (used by ASD-POCS), one TV gradient per step.  The gradient
  is :func:`repro_torch.kernels.tv_grad.tv_grad`: on a CUDA tensor the
  hand-written kernel (``csrc/tv_grad.cu``), on a CPU tensor its plain
  version.  The reference differentiates ``tv_value`` with ``jax.grad``;
  the kernel computes the same gradient in closed form, and its parity is
  held against that ``jax.grad`` (rtol 1e-5, atol 1e-5).
* :func:`rof_denoise` -- Chambolle's dual projection for the ROF model
  (FISTA-TV's proximal step), in plain PyTorch ops as the reference has it
  in plain ``jnp``: no kernel.

Both run on the device of the tensor they are given.

The halo-split versions (paper SS2.3, Fig 6) split the volume into z slabs
along the mesh's ``model`` axis, one shard each (the data-axis replicas of
the reference compute the same values, so the port computes once per model
index):

* :func:`dist_minimize_tv` is exact: each shard takes the TV gradient with
  :func:`tv_gradient` (the ``tv_grad`` kernel on the card) over the part of
  its halo-padded slab that lies inside the global volume, whose Neumann
  edges are the monolithic ones; the out-of-volume halo planes get a zero
  gradient.  That is the gradient of the reference's masked objective
  :func:`_tv_value_masked`, so the owned planes follow the monolithic
  iteration.  The global gradient norm is exact (a sum over the shards) or
  the paper's no-communication estimate ``sqrt(n_shards) * ||g_local||``.
* :func:`dist_rof_denoise` carries Chambolle's dual field across rounds,
  re-exchanging its halo; plain PyTorch ops, as in the reference.

A halo of depth ``N_in`` buys ``N_in`` independent inner iterations between
exchanges (the stencils have z radius 1).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..kernels.tv_grad import _forward_diff, tv_grad
from .device import as_f32, norm
from .distributed import (ShardStreams, _reduce_partial, halo_exchange,
                          model_devices, split_slabs)


# --------------------------------------------------------------------------
# TV value / gradient (forward differences, z-radius-1 stencil)
# --------------------------------------------------------------------------

def _tv_field(vol: torch.Tensor, eps: float) -> torch.Tensor:
    """|grad f| per voxel with edge-replicate (Neumann) forward
    differences."""
    dz, dy, dx = (_forward_diff(vol, d) for d in range(3))
    return torch.sqrt(dz * dz + dy * dy + dx * dx + eps * eps)


def tv_value(vol: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.sum(_tv_field(vol, eps))


def tv_gradient(vol: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gradient of :func:`tv_value`: the ``tv_grad`` kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    return tv_grad(vol, eps)


def minimize_tv(vol: torch.Tensor, hyper: float, n_iters: int = 20,
                eps: float = 1e-6) -> torch.Tensor:
    """TIGRE's ``minimizeTV``: steepest descent with norm-relative steps,
    ``v <- v - hyper * g / (||g|| + 1e-12)``.  The steps update a copy of
    ``vol`` in place (the same bits as the reference's expression), so the
    loop holds three volumes: ``vol``, the iterate and the gradient.  The
    norm stays a 0-d tensor on the device, so the loop never waits for
    it."""
    v = vol.clone()
    for _ in range(n_iters):
        g = tv_gradient(v, eps)
        gn = norm(g) + 1e-12
        v.sub_(g.mul_(hyper).div_(gn))
    return v


# --------------------------------------------------------------------------
# ROF model via Chambolle's dual projection
# --------------------------------------------------------------------------

def _grad3(v: torch.Tensor):
    return tuple(_forward_diff(v, d) for d in range(3))


def _div_axis(p: torch.Tensor, dim: int) -> torch.Tensor:
    """One axis of :func:`_div3`: p_0, p_i - p_{i-1} inside, -p_{n-2} at
    the last index; p itself for an axis of size 1."""
    n = p.shape[dim]
    if n <= 1:
        return p
    return torch.cat([p.narrow(dim, 0, 1),
                      p.narrow(dim, 1, n - 2) - p.narrow(dim, 0, n - 2),
                      -p.narrow(dim, n - 2, 1)], dim)


def _div3(pz: torch.Tensor, py: torch.Tensor, px: torch.Tensor):
    """Adjoint of ``_grad3`` (Chambolle's boundary convention)."""
    return _div_axis(pz, 0) + _div_axis(py, 1) + _div_axis(px, 2)


def _rof_step(p, f, tau: float):
    pz, py, px = p
    gz, gy, gx = _grad3(_div3(pz, py, px) - f)
    denom = 1.0 + tau * torch.sqrt(gz * gz + gy * gy + gx * gx)
    return ((pz + tau * gz) / denom, (py + tau * gy) / denom,
            (px + tau * gx) / denom)


def rof_denoise(vol: torch.Tensor, lam: float = 10.0, n_iters: int = 30,
                tau: float = 0.124) -> torch.Tensor:
    """Chambolle (2004) dual projection for min ||u - vol||^2/2 +
    TV(u)/lam."""
    f = vol * lam
    p = tuple(torch.zeros_like(vol) for _ in range(3))
    for _ in range(n_iters):
        p = _rof_step(p, f, tau)
    return vol - _div3(*p) / lam


# --------------------------------------------------------------------------
# distributed (halo-split) versions -- paper Fig 6
# --------------------------------------------------------------------------

def halo_overhead(planes_local: int, halo: int) -> float:
    """Fraction of redundant stencil work per shard for halo depth
    ``halo``."""
    return 2.0 * halo / max(planes_local, 1)


def _tv_value_masked(vol: torch.Tensor, plane_mask: torch.Tensor,
                     dz_mask: torch.Tensor, eps: float) -> torch.Tensor:
    """TV objective of a halo-padded slab, restricted to the global volume.

    ``plane_mask`` zeroes the |grad f| of halo planes beyond the global
    volume; ``dz_mask`` zeroes the z forward difference at the global last
    plane (the monolithic edge-replicate rule).  Its gradient on the
    in-volume planes is :func:`tv_gradient` of those planes alone, and 0 on
    the others: what :func:`dist_minimize_tv` computes."""
    dz = _forward_diff(vol, 0) * dz_mask[:, None, None]
    dy, dx = _forward_diff(vol, 1), _forward_diff(vol, 2)
    field = torch.sqrt(dz * dz + dy * dy + dx * dx + eps * eps)
    return torch.sum(field * plane_mask[:, None, None])


def _fake_plane_mask(planes_padded: int, depth: int, idx: int,
                     n_shards: int, device=None) -> torch.Tensor:
    """1.0 on the planes of shard ``idx``'s padded slab that exist in the
    global volume, 0.0 on out-of-volume halo planes (only the first and
    last shard have those)."""
    m = torch.ones(planes_padded, dtype=torch.float32, device=device)
    if idx == 0:
        m[:depth] = 0.0
    if idx == n_shards - 1:
        m[planes_padded - depth:] = 0.0
    return m


def _global_last_mask(planes_padded: int, depth: int, idx: int,
                      n_shards: int, device=None) -> torch.Tensor:
    """0.0 at the global last z plane (last shard only), 1.0 elsewhere."""
    m = torch.ones(planes_padded, dtype=torch.float32, device=device)
    if idx == n_shards - 1:
        m[planes_padded - depth - 1] = 0.0
    return m


def _halo_gradient(vp: torch.Tensor, depth: int, idx: int, n_shards: int,
                   eps: float):
    """The TV gradient of shard ``idx``'s halo-padded slab ``vp``: ``(lo,
    hi, g, own)`` with ``g`` the gradient of the planes ``[lo, hi)`` that
    lie inside the global volume (a contiguous view of ``vp``, so no copy;
    0 elsewhere) and ``own`` its view on the shard's own planes."""
    padded = vp.shape[0]
    lo = depth if idx == 0 else 0
    hi = padded - depth if idx == n_shards - 1 else padded
    g = tv_gradient(vp[lo:hi], eps)
    return lo, hi, g, g[depth - lo:padded - depth - lo]


def _gather(slabs: Sequence[torch.Tensor], shards: ShardStreams,
            dev0: torch.device) -> torch.Tensor:
    """The shards' slabs as one volume on ``dev0``."""
    shards.join(slabs)
    return torch.cat([s.to(dev0) for s in slabs])


def dist_minimize_tv(mesh, hyper: float, n_iters: int, n_inner: int,
                     approx_norm: bool = True, eps: float = 1e-6):
    """Halo-split steepest-descent TV minimiser: ``f(vol) -> vol`` on
    ``mesh.devices.flat[0]``.

    One halo exchange per ``n_inner`` inner iterations (``ceil(n_iters /
    n_inner)`` rounds, as the reference).  Each shard updates its padded
    slab in place, so the exchange gives it fresh storage.
    ``approx_norm`` selects the paper's no-sync norm estimate."""
    n_outer = -(-n_iters // n_inner)
    devs = model_devices(mesh)
    n = len(devs)
    shards = ShardStreams(devs)

    def fn(vol) -> torch.Tensor:
        vol = as_f32(vol, mesh.devices.flat[0])
        shards.fork()
        slabs = split_slabs(vol, shards)
        planes = slabs[0].shape[0]
        for _ in range(n_outer):
            vp = halo_exchange(slabs, n_inner, shards)
            for _ in range(n_inner):
                grads, sq = [], []
                for j in range(n):
                    with shards.on(j):
                        lo, hi, g, own = _halo_gradient(vp[j], n_inner, j, n,
                                                        eps)
                        grads.append((lo, hi, g))
                        # the paper's no-sync estimate assumes the gradient
                        # spreads evenly over the shards (SS2.3)
                        sq.append(norm(own) ** 2 * (n if approx_norm else 1))
                if not approx_norm:     # every shard needs the sum
                    total = _reduce_partial(sq, "psum", shards, range(n))
                    sq = [total] + [shards.copy(total, 0, j)
                                    for j in range(1, n)]
                for j, (lo, hi, g) in enumerate(grads):
                    with shards.on(j):
                        gn = torch.sqrt(sq[j]) + 1e-12
                        vp[j][lo:hi].sub_(g.mul_(hyper).div_(gn))
            slabs = [v[n_inner:n_inner + planes] for v in vp]
        return _gather(slabs, shards, mesh.devices.flat[0])
    return fn


def _masked_rof_step(p, f_pad, mask, gz_mask, tau: float):
    """Chambolle step reproducing the monolithic boundary convention: gz
    vanishes at the global last plane and the dual field is pinned to zero
    on out-of-volume planes (so div reads zeros there, like the monolithic
    p_{-1} == 0)."""
    pz, py, px = p
    gz, gy, gx = _grad3(_div3(pz, py, px) - f_pad)
    gz = gz * gz_mask
    denom = 1.0 + tau * torch.sqrt(gz * gz + gy * gy + gx * gx)
    return ((pz + tau * gz) / denom * mask, (py + tau * gy) / denom * mask,
            (px + tau * gx) / denom * mask)


def dist_rof_denoise(mesh, lam: float, n_iters: int, n_inner: int,
                     tau: float = 0.124):
    """Halo-split Chambolle/ROF with a persistent dual field: ``f(vol) ->
    vol`` on ``mesh.devices.flat[0]``.

    The image is exchanged once (it never changes); the three dual
    components exchange their halos every round.  The halo is one plane
    deeper than the inner iteration count: Chambolle's div/grad edge
    conventions corrupt two halo planes in the first inner iteration."""
    n_outer = -(-n_iters // n_inner)
    depth = n_inner + 1
    devs = model_devices(mesh)
    n = len(devs)
    shards = ShardStreams(devs)

    def owned(comp: List[torch.Tensor], padded: int) -> List[torch.Tensor]:
        return [c[depth:padded - depth] for c in comp]

    def fn(vol) -> torch.Tensor:
        vol = as_f32(vol, mesh.devices.flat[0])
        shards.fork()
        slabs = split_slabs(vol, shards)
        planes = slabs[0].shape[0]
        padded = planes + 2 * depth
        f_pad, masks, p = [], [], []
        for j, fp in enumerate(halo_exchange(slabs, depth, shards)):
            with shards.on(j):
                f_pad.append(fp * lam)
                masks.append((
                    _fake_plane_mask(padded, depth, j, n,
                                     devs[j])[:, None, None],
                    _global_last_mask(padded, depth, j, n,
                                      devs[j])[:, None, None]))
                p.append(tuple(torch.zeros_like(fp) for _ in range(3)))
        for _ in range(n_outer):
            # refresh the dual halos from the neighbours' owned planes
            comps = [halo_exchange(owned([q[c] for q in p], padded), depth,
                                   shards) for c in range(3)]
            p = [tuple(comp[j] for comp in comps) for j in range(n)]
            for _ in range(n_inner):
                for j in range(n):
                    with shards.on(j):
                        p[j] = _masked_rof_step(p[j], f_pad[j], *masks[j],
                                                tau)
        # a final depth-1 halo so div reads a valid neighbour plane
        comps = [halo_exchange(owned([q[c] for q in p], padded), 1, shards)
                 for c in range(3)]
        out = []
        for j in range(n):
            with shards.on(j):
                u_pad = (f_pad[j][depth - 1:padded - depth + 1] / lam
                         - _div3(*(comp[j] for comp in comps)) / lam)
                out.append(u_pad[1:1 + planes])
        return _gather(out, shards, mesh.devices.flat[0])
    return fn
