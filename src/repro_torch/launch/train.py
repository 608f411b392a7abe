"""The trainer: any registered arch (reduced or full config) on one
device, with the fault-tolerance substrate wired in -- deterministic data,
async checkpoints, the preemption hook, the straggler watchdog.

Port of ``repro/launch/train.py`` for one device: no mesh, no model axis,
no ZeRO-1 (ROADMAP A3.4).  It runs on the current CUDA device unless
``device="cpu"`` (``--device cpu``) is passed.  On the card a GQA layer's
attention and its gradient run the hand-written kernels (the forward with
its row statistics, then the backward kernels for dq, dk and dv); on the
CPU the plain attention runs and autograd differentiates it.  Every config
trains that fits one device: on one 80 GB card stablelm-1.6b and
xlstm-350m at full width and depth (the 7B-16B configs need sharding,
ROADMAP A3.4).

Usage::

    # on the card: stablelm-1.6b at full width, train_4k cut to 4 x 4096
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --steps 3 --batch 4 --seq 4096
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
from ..optim import AdamWConfig, adamw_init
from .steps import make_train_step


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
          model: Optional[LM] = None,
          history: Optional[List[Dict[str, Any]]] = None):
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
    Returns (the model, the optimizer state, the losses of the steps
    run)."""
    if model is None:
        cfg = reduced_cfg(arch) if use_reduced else get_config(arch)
        dev = resolve_device(device)
        model = LM(cfg, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(seed))
    cfg, dev = model.cfg, model.device
    opt_cfg = AdamWConfig(lr=lr)
    data_cfg = TokenPipelineConfig(vocab=cfg.vocab, seq_len=seq,
                                   global_batch=batch, seed=seed)
    pipe = TokenPipeline(data_cfg)
    step_fn = make_train_step(model, opt_cfg, 10, steps)
    params = dict(model.named_parameters())
    opt_state = adamw_init(params)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    guard = guard or PreemptionGuard(install_handler=False)
    dog = StepWatchdog()
    start = 0
    if mgr is not None:
        got, tree = mgr.restore_latest({"params": params, "opt": opt_state})
        if got is not None:
            start = got + 1
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(torch.as_tensor(tree["params"][name]))
            opt_state = _to_device(tree["opt"], dev)
            if verbose:
                print(f"[train] resumed from step {got}")

    losses = []
    for step in range(start, steps):
        dog.start_step()
        t0 = time.perf_counter()
        if cfg.encoder_only or cfg.family == "audio":
            feats, labels = feature_batch(data_cfg, step, cfg.d_model)
            tokens = torch.from_numpy(feats).to(dev, cfg.dtype)
        else:
            toks, labels = pipe.batch(step)
            tokens = torch.from_numpy(toks).to(dev)
        ctx = None
        if cfg.family == "vlm":
            rng = np.random.default_rng((seed, step, 99))
            ctx = torch.from_numpy(rng.standard_normal(
                (batch, cfg.n_ctx_tokens, cfg.d_model))).to(dev, cfg.dtype)
        opt_state, metrics = step_fn(opt_state, tokens,
                                     torch.from_numpy(labels).to(dev), ctx)
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
            mgr.save(step, {"params": params, "opt": opt_state})
        if guard.preempted:
            if mgr is not None:
                mgr.save(step, {"params": params, "opt": opt_state},
                         blocking=True)
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
    args = ap.parse_args(argv)
    train(args.arch, steps=args.steps, use_reduced=args.reduced,
          batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
          lr=args.lr, device=args.device,
          guard=PreemptionGuard(install_handler=True))


if __name__ == "__main__":
    main()
