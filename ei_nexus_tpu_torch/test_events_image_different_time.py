"""Relative pose benchmark on time-separated event/image pairs: the
headline metric (RPE AUC@{5,10,20}).

The port's counterpart of the repository's
`test_events_image_different_time.py`, over the config's validation
pairs (MVSEC's index pairs, or EC's `new_<seq>_val.txt`):

    python -m ei_nexus_tpu_torch.test_events_image_different_time \\
        --config configs/train_EIM_stage2.yaml --ckpt RUN/checkpoints/final \\
        [--backend opencv|torch] [--solver 5pt|8pt] [--max-batches N] \\
        [--device cuda] [key=value overrides, e.g. dataset=test_ec ...]

`--backend torch` is the JAX package's `--backend jax`: the batched
RANSAC on the device. Prints the metrics as one JSON dict. Runs on the
card unless `--device` names another.
"""

from __future__ import annotations


def main(argv=None):
    from .data import DataLoader
    from .train.evaluate import (build_eval_model, eval_arguments,
                                 print_metrics, rpe_eval, val_dataset)
    from .device import resolve_device
    from .utils import load_config

    args = eval_arguments("configs/train_EIM_stage2.yaml",
                          __doc__.split("\n\n")[0],
                          backend=True).parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    ds_cfg = cfg.dataset.to_dict()
    H, W = ds_cfg["resolution"]
    loader = DataLoader(val_dataset(ds_cfg),
                        batch_size=ds_cfg.get("val", {}).get("batch_size", 1),
                        shuffle=False, drop_last=False)
    model = build_eval_model(cfg.model.to_dict(), args.ckpt, dev)
    metrics = rpe_eval(model, loader, ds_cfg["representation_type"],
                       ds_cfg["channel"], H, W, pose_thresh=(5, 10, 20),
                       backend=args.backend, solver=args.solver,
                       max_batches=args.max_batches)
    print_metrics(metrics)
    return metrics


if __name__ == "__main__":
    main()
