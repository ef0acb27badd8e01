"""Matcher validation entry point: the stage-2 loss and the assignment
metrics (match recall, precision, accuracy, average precision) on pairs
with depth, then the relative pose benchmark (RPE AUC) on the validation
pairs.

The port's counterpart of the repository's `val_matcher.py`: the GT
matches come from pose and depth as in training, with the trainer's
`train.gt_matches` thresholds and LightGlue's loss settings; the loss
part stops at the first batch without depth (EC has none), the RPE part
runs on every dataset.

    python -m ei_nexus_tpu_torch.val_matcher \\
        --config configs/train_EIM_stage2.yaml --ckpt RUN/checkpoints/final \\
        [--max-batches N] [--device cuda] [key=value overrides...]

Prints the metrics as one JSON dict. Runs on the card unless `--device`
names another.
"""

from __future__ import annotations


def main(argv=None):
    from .data import DataLoader
    from .train.evaluate import (build_eval_model, eval_arguments,
                                 matcher_val_losses, print_metrics, rpe_eval,
                                 val_dataset)
    from .device import resolve_device
    from .utils import load_config

    args = eval_arguments("configs/train_EIM_stage2.yaml",
                          __doc__.split("\n\n")[0]).parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    ds_cfg = cfg.dataset.to_dict()
    H, W = ds_cfg["resolution"]
    bins, rep = ds_cfg["channel"], ds_cfg["representation_type"]
    loader = DataLoader(val_dataset(ds_cfg), batch_size=1, shuffle=False,
                        drop_last=False)
    model = build_eval_model(cfg.model.to_dict(), args.ckpt, dev)
    # the hyperparameters the trainer reads
    gtc = cfg.get_path("train.gt_matches", {}) or {}
    lgc = model.config.matcher.lightglue
    metrics = matcher_val_losses(
        model, loader, rep, bins, H, W,
        pos_th=float(gtc.get("pos_th", 3.0)),
        neg_th=float(gtc.get("neg_th", 5.0)), gamma=lgc.gamma,
        nll_balancing=lgc.nll_balancing, max_batches=args.max_batches)
    metrics.update(rpe_eval(model, loader, rep, bins, H, W,
                            max_batches=args.max_batches))
    print_metrics(metrics)
    return metrics


if __name__ == "__main__":
    main()
