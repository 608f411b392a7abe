"""The trainer: any registered arch (reduced or full config) on one
device, or a dense GQA, MLA, cross-attention or Mamba2 config on a mesh,
with the
fault-tolerance substrate wired in -- deterministic data, async
checkpoints, the preemption hook, the straggler watchdog, elastic
restore.

Port of ``repro/launch/train.py``.  It runs on the current CUDA device
unless ``device="cpu"`` (``--device cpu``) is passed; with ``model_axis``
> 1 or ``devices`` (``--model-axis``, ``--devices``) it runs on the
(data, model) mesh ``make_host_mesh(model_axis, devices)`` (every GPU
when ``devices`` is None; a device may repeat, as the reference's forced
host devices stand in for a pod), tensor parallel over ``model``, data
parallel over ``data``, with ZeRO-1 (:class:`ShardedLM`: every config
whose kinds are in its ``MESH_KINDS``, the dense GQA configs, minicpm3-4b,
zamba2-7b and llama-3.2-vision-11b, whose seeded image context is split
over the data replicas with the tokens).  On the card a GQA layer's
attention and its gradient run the hand-written kernels (the forward
with its row statistics, then the backward kernels for dq, dk and dv),
on every shard; MLA, cross-attention and Mamba2 run in plain ops, as the
reference's; on the CPU the plain attention runs and autograd
differentiates it.  On one 80 GB
card stablelm-1.6b and xlstm-350m train at full width and depth, and on
a (data 2, model 2) mesh of four ``cuda:0`` shards stablelm-1.6b at full
depth, minicpm3-4b at 16 of its 62 layers, zamba2-7b at its prelude and
two pattern units (15 of 81 layers) and llama-3.2-vision-11b at one
pattern unit (their state at full depth does not fit one card).
Checkpoints hold the full logical leaves, whatever the mesh: a run
resumes on its own mesh bit for bit, and on another mesh (or one device)
within float32's rounding.

Usage::

    # on the card: stablelm-1.6b at full width, train_4k cut to 4 x 4096
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --steps 3 --batch 4 --seq 4096
    # the same on a (data 2, model 2) mesh of one card's four shards
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --steps 3 --batch 4 --seq 4096 --model-axis 2 \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0
    # reduced llama-3.2-vision-11b on a (2, 2) CPU mesh, image context and all
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama-3.2-vision-11b --reduced --steps 20 --batch 4 --seq 16 \\
        --model-axis 2 --devices cpu,cpu,cpu,cpu --ckpt-dir build/ckpt_vlm
    # reduced zamba2-7b (Mamba2 head parallel, the shared attention block
    # called at 3 sites) on a (2, 2) CPU mesh
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
        --reduced --steps 4 --batch 4 --seq 16 --model-axis 2 \\
        --devices cpu,cpu,cpu,cpu
    # CPU smoke
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
        --reduced --steps 50 --batch 8 --seq 128 --device cpu \\
        --ckpt-dir build/ckpt
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager, PreemptionGuard
from ..configs import get_config, reduced as reduced_cfg
from ..core.device import DeviceLike, resolve_device
from ..data import TokenPipeline, TokenPipelineConfig, feature_batch
from ..distributed import StepWatchdog
from ..models.lm import LM
from ..models.sharded_lm import ShardedLM
from ..optim import (AdamWConfig, adamw_init, adamw_init_mesh,
                     gather_opt_mesh, split_opt_mesh)
from .mesh import make_host_mesh
from .steps import make_train_step


def _target(model: ShardedLM) -> Dict[str, Any]:
    """A checkpoint's structure and shapes for a sharded model (meta
    tensors): the full parameters and float32 moments, the step."""
    def full(dtype=None):
        return {n: torch.empty(lay.shape, dtype=dtype or lay.dtype,
                               device="meta")
                for n, lay in model.layouts.items()}
    return {"params": full(),
            "opt": {"m": full(torch.float32), "v": full(torch.float32),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def train(arch: Optional[str] = None, steps: int = 50,
          use_reduced: bool = True, batch: int = 8, seq: int = 128,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
          lr: float = 3e-4, seed: int = 0,
          log_every: int = 10, guard: Optional[PreemptionGuard] = None,
          verbose: bool = True, device: DeviceLike = None,
          model=None, history: Optional[List[Dict[str, Any]]] = None,
          model_axis: int = 1, devices: Optional[List[DeviceLike]] = None):
    """Train ``arch`` for ``steps`` AdamW steps (lr ``lr``, 10 warmup steps,
    cosine decay over ``steps``) on the deterministic token pipeline (an
    encoder: ``feature_batch`` frames; a VLM: a seeded image context per
    step), batch ``batch`` of ``seq`` tokens.  The model is a new one of
    ``arch`` (its reduced config with ``use_reduced``) drawn from ``seed``
    on ``device``; or ``model``, whose config and device are then the
    run's (``arch``, ``use_reduced`` and ``device`` are not read).  With
    ``ckpt_dir`` it resumes from the last committed checkpoint there and
    saves every ``ckpt_every`` steps; when ``guard`` reports a preemption
    it saves the step it finished and stops.  ``history``, when given,
    receives one ``{"step", "loss", "grad_norm", "seconds"}`` per step.
    With ``model_axis`` > 1 or ``devices``, or a :class:`ShardedLM` as
    ``model``, the run is on a mesh (with ZeRO-1; a one-device
    ``model`` is split onto it), the new model drawn on the mesh's first
    device.  Returns (the model, the optimizer state, the losses of the
    steps run)."""
    mesh = None
    if devices is not None or model_axis > 1:
        mesh = make_host_mesh(model_axis, devices)
    if model is None:
        cfg = reduced_cfg(arch) if use_reduced else get_config(arch)
        dev = resolve_device(mesh.devices.flat[0] if mesh is not None
                             else device)
        model = LM(cfg, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(seed))
    if mesh is not None and not isinstance(model, ShardedLM):
        model = ShardedLM(model, mesh)
    sharded = isinstance(model, ShardedLM)
    cfg = model.cfg
    dev = model.device
    opt_cfg = AdamWConfig(lr=lr)
    data_cfg = TokenPipelineConfig(vocab=cfg.vocab, seq_len=seq,
                                   global_batch=batch, seed=seed)
    pipe = TokenPipeline(data_cfg)
    step_fn = make_train_step(model, opt_cfg, 10, steps)
    if sharded:
        opt_state = adamw_init_mesh(model)
    else:
        params = dict(model.named_parameters())
        opt_state = adamw_init(params)

    def snapshot():
        """What a checkpoint holds: the full parameters and moments."""
        if sharded:
            return {"params": model.gather(),
                    "opt": gather_opt_mesh(model, opt_state)}
        return {"params": params, "opt": opt_state}

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    guard = guard or PreemptionGuard(install_handler=False)
    dog = StepWatchdog()
    start = 0
    if mgr is not None:
        got, tree = mgr.restore_latest(_target(model) if sharded
                                       else snapshot())
        if got is not None:
            start = got + 1
            full = {n: torch.as_tensor(v) for n, v in tree["params"].items()}
            if sharded:
                model.load_(full)
                opt_state = split_opt_mesh(model, tree["opt"])
            else:
                with torch.no_grad():
                    for name, p in params.items():
                        p.copy_(full[name])
                opt_state = _to_device(tree["opt"], dev)
            if verbose:
                print(f"[train] resumed from step {got}")

    losses = []
    for step in range(start, steps):
        dog.start_step()
        t0 = time.perf_counter()
        # a sharded step places each replica's rows on its own shards
        to = torch.device("cpu") if sharded else dev
        if cfg.encoder_only or cfg.family == "audio":
            feats, labels = feature_batch(data_cfg, step, cfg.d_model)
            tokens = torch.from_numpy(feats).to(to, cfg.dtype)
        else:
            toks, labels = pipe.batch(step)
            tokens = torch.from_numpy(toks).to(to)
        ctx = None
        if cfg.family == "vlm":
            rng = np.random.default_rng((seed, step, 99))
            ctx = torch.from_numpy(rng.standard_normal(
                (batch, cfg.n_ctx_tokens, cfg.d_model))).to(to, cfg.dtype)
        opt_state, metrics = step_fn(opt_state, tokens,
                                     torch.from_numpy(labels).to(to), ctx)
        loss = float(metrics["loss"])
        losses.append(loss)
        straggler = dog.end_step()
        seconds = time.perf_counter() - t0
        if history is not None:
            history.append({"step": step, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "seconds": seconds})
        if verbose and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{seconds:.3f} s"
                  + (" [straggler]" if straggler else ""), flush=True)
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step, snapshot())
        if guard.preempted:
            if mgr is not None:
                mgr.save(step, snapshot(), blocking=True)
            if verbose:
                print(f"[train] preempted at step {step}; "
                      "checkpoint committed")
            break
    if mgr is not None:
        mgr.wait()
    return model, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="shards of the mesh's model axis (> 1: a mesh)")
    ap.add_argument("--devices", default=None,
                    help="the mesh's devices, comma-separated, a device "
                    "may repeat (default with --model-axis > 1: every GPU)")
    args = ap.parse_args(argv)
    train(args.arch, steps=args.steps, use_reduced=args.reduced,
          batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
          lr=args.lr, device=args.device, model_axis=args.model_axis,
          devices=args.devices.split(",") if args.devices else None,
          guard=PreemptionGuard(install_handler=True))


if __name__ == "__main__":
    main()
