"""Train a ~100M-parameter LM on the synthetic token pipeline with the
PyTorch port, with checkpointing and fault tolerance wired in: the port's
counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \
        [--ckpt-dir build/lm_ckpt]
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --small

It runs on the current CUDA device unless ``--device cpu`` is passed.  It
checkpoints only with ``--ckpt-dir``, and then resumes from the last
checkpoint in that directory: a run of another size needs another one.  The
~100M config is the reference example's stablelm-family decoder (8 GQA
layers of 12 heads of 64); on the card its attention and the attention's
gradient run the hand-written flash_attention kernels.  ``--small`` is a
quick look at a tiny size.
"""

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint and resume here (default: none)")
    args = ap.parse_args(argv)

    from repro_torch.launch import train as T
    from repro_torch.models.lm import LM, ArchConfig

    # ~100M params: 8 layers, d=768, 32k vocab (the reference example's)
    cfg = ArchConfig(
        name="lm-100m", family="dense", n_layers=8, d_model=768,
        n_heads=12, n_kv=12, d_ff=3072, vocab=32000, pattern=("attn",),
        sub_quadratic=False)
    if args.small:
        cfg = dataclasses.replace(cfg, n_layers=2, d_model=128, n_heads=4,
                                  n_kv=4, d_ff=512, vocab=2048)

    model = LM(cfg, device=args.device)
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.steps} steps")
    T.train(model=model, steps=args.steps,
            batch=8, seq=256 if not args.small else 64,
            ckpt_dir=args.ckpt_dir, ckpt_every=100, lr=6e-4,
            log_every=10)


if __name__ == "__main__":
    main()
