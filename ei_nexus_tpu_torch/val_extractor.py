"""Extractor validation entry point: same-time keypoint and descriptor
metrics (R@1/3, VVD, MMA@1/3, MR, HE AUC) and the validation losses.

The port's counterpart of the repository's `val_extractor.py`, over the
config's validation split:

    python -m ei_nexus_tpu_torch.val_extractor \\
        --config configs/train_EIM_stage1_EC_SP_MNN.yaml \\
        --ckpt RUN/checkpoints/final [--max-batches N] [--device cuda] \\
        [key=value overrides...]

Prints the metrics as one JSON dict. Runs on the card unless `--device`
names another.
"""

from __future__ import annotations


def main(argv=None):
    from .losses import build_losses
    from .data import DataLoader
    from .train.evaluate import (build_eval_model, eval_arguments,
                                 print_metrics, val_dataset, val_extractor)
    from .device import resolve_device
    from .utils import load_config

    args = eval_arguments("configs/train_EIM_stage1_MVSEC_SP_MNN.yaml",
                          __doc__.split("\n\n")[0]).parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    ds_cfg = cfg.dataset.to_dict()
    H, W = ds_cfg["resolution"]
    loader = DataLoader(val_dataset(ds_cfg),
                        batch_size=ds_cfg.get("val", {}).get("batch_size", 1),
                        shuffle=False, drop_last=False)
    model = build_eval_model(cfg.model.to_dict(), args.ckpt, dev)
    losses = build_losses(cfg.get_path("train.loss", {}) or {})
    metrics = val_extractor(model, loader, ds_cfg["representation_type"],
                            ds_cfg["channel"], H, W, losses=losses,
                            max_batches=args.max_batches)
    print_metrics(metrics)
    return metrics


if __name__ == "__main__":
    main()
