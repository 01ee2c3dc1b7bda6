"""Posterior export tool (torch), port of
torchain_tpu/cli/export_posteriors.py.

Loads a trainer checkpoint, runs the chain-head forward over utterances,
and writes per-utterance pseudo-loglike matrices to a Kaldi TEXT archive
(`ark,t:` compatible): the role torchain's matrix writer and example loop
played before shelling out to latgen-faster-mapped.

Without a checkpoint the model is the seeded init (--seed).  Runs on the
card unless asked otherwise (`--device cpu`); without a CUDA device and
without `--device cpu` it exits 2.

Usage (synthetic demo):
  python -m torchain_tpu_torch.cli.export_posteriors --synthetic \\
      --checkpoint-dir ckpts --out posts.ark
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num-utts", type=int, default=16)
    p.add_argument("--num-phones", type=int, default=8)
    p.add_argument("--feat-dim", type=int, default=24)
    p.add_argument("--model", choices=("tdnn", "tdnnf", "conformer"), default="tdnnf")
    p.add_argument("--hidden-dim", type=int, default=256)
    p.add_argument("--bottleneck-dim", type=int, default=64)
    p.add_argument("--num-layers", type=int, default=5)
    p.add_argument("--checkpoint-dir", default=None, help="trainer checkpoint to load")
    p.add_argument("--out", required=True, help="output text-ark path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions of the kernels)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if not args.synthetic:
        print("only --synthetic corpora are wired up in-round", file=sys.stderr)
        return 2

    from torchain_tpu_torch.cli.train import _build_model, resolve_device
    from torchain_tpu_torch.data import synthetic_dataset
    from torchain_tpu_torch.io import MatrixWriter
    from torchain_tpu_torch.train.step import make_forward_fn

    device = resolve_device(args.device)
    corpus = synthetic_dataset(
        num_utts=args.num_utts,
        num_phones=args.num_phones,
        feat_dim=args.feat_dim,
        seed=args.seed,
    )
    model, cfg = _build_model(args, corpus.tree.num_pdfs, args.feat_dim, device)
    left, right = cfg.context
    fsf = cfg.frame_subsampling_factor
    if args.checkpoint_dir:
        from torchain_tpu_torch.ops import auto_den_graph
        from torchain_tpu_torch.train import Trainer, TrainerConfig

        trainer = Trainer(
            model,
            auto_den_graph(corpus.den_graph, device=device, phone_lm=corpus.phone_lm,
                           tree=corpus.tree),
            TrainerConfig(checkpoint_dir=args.checkpoint_dir, device=str(device)),
        )
        if not trainer.restore_checkpoint():
            print("no checkpoint found; exporting with random init", file=sys.stderr)

    forward = make_forward_fn(model)
    n = 0
    with MatrixWriter(args.out) as w:
        for utt in corpus.utts:
            T_in_utt = utt.feats.shape[0]
            t_out = T_in_utt // fsf
            idx = np.clip(np.arange(-left, t_out * fsf + right), 0, T_in_utt - 1)
            feats = torch.as_tensor(utt.feats[idx][None]).to(device)
            w[utt.utt_id] = forward(feats)[0].float().cpu().numpy()
            n += 1
    print(f"wrote {n} posterior matrices to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
