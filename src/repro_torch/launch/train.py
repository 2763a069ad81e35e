"""End-to-end training launcher, ported from ``repro.launch.train``: Bullion
data -> ``BullionLoader`` -> model -> AdamW, with checkpoints and
auto-resume from the loader's ``(epoch, group)`` cursor. Computes in f32.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --steps 50 --batch 8 --seq 128

runs on the card (``--device``, default ``cuda``; raises where CUDA is
absent unless given ``--device cpu``). The corpus and the checkpoints go
under the system's temporary directory unless ``--data``/``--ckpt`` name
others.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from .. import configs, resolve_device
from ..data import BullionLoader, LoaderState, write_lm_corpus
from ..models import zoo
from ..train import AdamWConfig, adamw_init, make_train_step
from ..train.checkpoint import CheckpointManager


def main(argv=None) -> list[float]:
    """Train; returns the loss of every step this run took."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data",
                    default=os.path.join(tempfile.gettempdir(), "bullion_lm"))
    ap.add_argument("--ckpt",
                    default=os.path.join(tempfile.gettempdir(), "bullion_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (0 = config default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    cfg = cfg.scaled(compute_dtype="float32")
    if args.d_model:
        cfg = cfg.scaled(d_model=args.d_model,
                         head_dim=args.d_model // cfg.n_heads,
                         d_ff=args.d_model * 4)
    model = zoo.build(cfg, device=dev, seed=0)

    os.makedirs(args.data, exist_ok=True)
    corpus = os.path.join(args.data, "corpus.bln")
    if not os.path.exists(corpus):
        stats = write_lm_corpus(corpus, vocab=cfg.vocab,
                                n_docs=max(64, args.batch * 8),
                                doc_len=max(512, args.seq * 4))
        print(f"wrote corpus: {stats}")

    mgr = CheckpointManager(args.ckpt, keep=2)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    opt_state = adamw_init(model)
    start_step = 0
    loader_state = LoaderState()

    if mgr.latest_step() is not None:
        _, manifest = mgr.restore((model, opt_state), device=dev)
        start_step = manifest["step"]
        loader_state = LoaderState(manifest.get("epoch", 0),
                                   manifest.get("group", 0))
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches,
                              device=dev)
    loader = BullionLoader(corpus, batch_size=args.batch, seq_len=args.seq,
                           state=loader_state, device=dev)

    it = iter(loader)
    t0 = time.perf_counter()
    losses = []
    try:
        for step in range(start_step, args.steps):
            batch_np, cursor = next(it)
            metrics = step_fn(opt_state, {"tokens": batch_np})
            losses.append(float(metrics["loss"]))
            if (step + 1) % args.log_every == 0:
                dt = time.perf_counter() - t0
                tok_s = args.log_every * args.batch * args.seq / dt
                print(f"step {step+1:5d} loss "
                      f"{np.mean(losses[-args.log_every:]):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} tok/s {tok_s:,.0f}")
                t0 = time.perf_counter()
            if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
                mgr.save(step + 1, (model, opt_state),
                         extra={"epoch": cursor.epoch, "group": cursor.group,
                                "loss": losses[-1]})
        mgr.wait()
    finally:
        loader.close()
    if not losses:
        print(f"done: nothing to do (at step {start_step} of {args.steps})")
        return losses
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    print(f"done: loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
