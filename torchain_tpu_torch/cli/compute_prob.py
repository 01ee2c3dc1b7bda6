"""Diagnostics over egs archives: the nnet3-chain-compute-prob role (torch),
port of torchain_tpu/cli/compute_prob.py.

Given merged cegs archives + den.fst (+ an optional trainer checkpoint),
runs the chain objective forward over every record, with no parameter
update and no denominator backward, and prints the overall per-frame
log-probability: the number Kaldi's train script greps from
compute_prob_{train,valid} logs to track convergence.

Runs on the card unless asked otherwise (`--device cpu`); without a CUDA
device and without `--device cpu` it exits 2.

Usage:
  python -m torchain_tpu_torch.cli.compute_prob \\
      --cegs 'valid_cegs.*.ark' --den-fst den.fst \\
      --checkpoint-dir exp/ckpts --model tdnnf
"""

from __future__ import annotations

import argparse
import json
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cegs", required=True, help="merged cegs archives (comma-separated and/or globs)")
    p.add_argument("--den-fst", required=True, help="denominator FST (binary OpenFst or text)")
    p.add_argument("--checkpoint-dir", default=None, help="trainer checkpoint to load (else random init)")
    p.add_argument("--num-pdfs", type=int, default=0, help="output dim (default: the egs' label_dim)")
    p.add_argument("--no-ivector", action="store_true", help="ignore the egs' ivector io")
    p.add_argument("--model", choices=("tdnn", "tdnnf", "cnn-tdnn", "tdnn-lstm", "conformer"),
                   default="tdnnf")
    p.add_argument("--ignore-deriv-weights", action="store_true",
                   help="treat non-uniform deriv_weights as 1.0")
    p.add_argument("--hidden-dim", type=int, default=256)
    p.add_argument("--bottleneck-dim", type=int, default=64)
    p.add_argument("--num-layers", type=int, default=5)
    p.add_argument("--l2-regularize", type=float, default=5e-5)
    p.add_argument("--leaky-hmm-coefficient", type=float, default=0.1)
    p.add_argument("--xent-regularize", type=float, default=0.1)
    p.add_argument("--max-batches", type=int, default=0, help="stop after N records (0 = all)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions of the kernels)")
    return p


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    from torchain_tpu_torch.cli.train import cegs_setup, resolve_device
    from torchain_tpu_torch.ops import ChainLossOptions
    from torchain_tpu_torch.train import Trainer, TrainerConfig

    device = resolve_device(args.device)
    setup = cegs_setup(args, device, tag="compute-prob")
    tcfg = TrainerConfig(
        batch_size=setup["bsz"],
        checkpoint_dir=args.checkpoint_dir,
        loss=ChainLossOptions(
            l2_regularize=args.l2_regularize,
            leaky_hmm_coefficient=args.leaky_hmm_coefficient,
            xent_regularize=args.xent_regularize,
        ),
        device=str(device),
    )
    trainer = Trainer(setup["model"], setup["den"], tcfg)
    restored = False
    if args.checkpoint_dir:
        restored = trainer.restore_checkpoint()
        if not restored:
            print(f"no checkpoint under {args.checkpoint_dir}; evaluating a random init",
                  file=sys.stderr)
    res = trainer.evaluate(setup["dataset"], max_batches=args.max_batches)
    w = max(res.tot_weight, 1e-20)
    frames = int(res.tot_weight)
    # the two log lines Kaldi's train script greps for
    print(
        f"Overall log-probability for 'output' is {res.objf:.4f} + "
        f"{res.tot_l2 / w:.4f} (l2) per frame, over {frames} frames."
    )
    print(
        f"Overall log-probability for 'output-xent' is "
        f"{res.tot_xent / w:.4f} per frame, over {frames} frames."
    )
    out = dict(
        objf=float(res.objf),
        l2_term=float(res.tot_l2 / w),
        xent_objf=float(res.tot_xent / w),
        frames=frames,
        restored=bool(restored),
    )
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
