"""Keypoint and descriptor benchmark on time-synchronised event/image
pairs (identity homography): R@1/3, VVD@1/3, MMA@1/3, MR and the
homography estimation AUC over the validation sequences' single views.

The port's counterpart of the repository's
`test_events_image_same_time.py`:

    python -m ei_nexus_tpu_torch.test_events_image_same_time \\
        --config configs/train_EIM_stage1_EC_SP_MNN.yaml \\
        --ckpt RUN/checkpoints/final [--max-batches N] [--device cuda] \\
        [key=value overrides...]

`dataset.val_sequences` replaces the stock sequence list. Prints the
metrics as one JSON dict. Runs on the card unless `--device` names
another.
"""

from __future__ import annotations


def main(argv=None):
    from .data import DataLoader
    from .data.ec import ECPairDataset, VAL_SEQUENCES as EC_VAL_SEQUENCES
    from .data.mvsec import MVSECPairDataset, VAL_SEQUENCES
    from .train.evaluate import (build_eval_model, eval_arguments,
                                 print_metrics, val_extractor)
    from .device import resolve_device
    from .utils import load_config

    args = eval_arguments("configs/train_EIM_stage1_MVSEC_SP_MNN.yaml",
                          __doc__.split("\n\n")[0]).parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    ds_cfg = cfg.dataset.to_dict()
    H, W = ds_cfg["resolution"]
    # the same-time protocol: single views of the validation sequences
    if ds_cfg["name"] == "mvsec":
        val_ds = MVSECPairDataset(
            ds_cfg["data_path"], ds_cfg.get("val_sequences") or VAL_SEQUENCES,
            ds_cfg["event_dt"], ds_cfg.get("max_events", 1 << 18),
            mode="single")
    else:
        val_ds = ECPairDataset(
            ds_cfg["data_path"],
            ds_cfg.get("val_sequences") or EC_VAL_SEQUENCES,
            ds_cfg["event_dt"], ds_cfg.get("max_events", 1 << 17),
            mode="single")
    loader = DataLoader(val_ds, batch_size=1, shuffle=False, drop_last=False)
    model = build_eval_model(cfg.model.to_dict(), args.ckpt, dev)
    metrics = val_extractor(model, loader, ds_cfg["representation_type"],
                            ds_cfg["channel"], H, W,
                            max_batches=args.max_batches)
    print_metrics(metrics)
    return metrics


if __name__ == "__main__":
    main()
