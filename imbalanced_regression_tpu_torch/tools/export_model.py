"""Export a trained checkpoint as a self-contained serving artifact.

Builds the task's model, restores the port's checkpoint (``latest.pt`` or
``best.pt`` in a store dir, ``utils/checkpoint.py``) and writes a frozen
``torch.export`` predictor (``serving.py``) that serves without the model
code or the checkpoint. The counterpart of the JAX package's
``tools/export_model.py``; the reference has in-script eval only
(``imdb-wiki-dir/train.py:103-110``).

Usage::

    python -m imbalanced_regression_tpu_torch.tools.export_model <store dir> <out.pt2> \
        [--task age|nyud2] [--batch 8] [--img_size 224] [--which best] \
        [--platforms cuda cpu] [--input_dtype uint8|float32] [--device cuda|cpu]

Smoke-load the artifact::

    python -m imbalanced_regression_tpu_torch.tools.export_model --load <out.pt2> --batch 8

The model runs on the GPU unless ``--device cpu`` is given; each entry of
``--platforms`` (default ``cuda``) is traced on its own device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

NYUD2_HW = (228, 304)  # the reference's crop (nyud2-dir/loaddata.py)


def build_task(task: str, config_overrides: dict, device: str = "cuda"):
    """(trainer, freshly initialized state) of ``task`` (``age``: the
    ``ExperimentConfig.model`` backbone from the ResNet family registry;
    ``nyud2``: the depth encoder-decoder) on ``device``, with the config's
    defaults under ``config_overrides``."""
    if task == "age":
        from imbalanced_regression_tpu_torch.tasks.age import build_trainer
        from imbalanced_regression_tpu_torch.utils.config import ExperimentConfig

        trainer = build_trainer(ExperimentConfig(**config_overrides, device=device))
    elif task == "nyud2":
        from imbalanced_regression_tpu_torch.tasks.nyud2 import NYUDConfig, build_nyud_trainer

        trainer = build_nyud_trainer(NYUDConfig(**config_overrides, device=device))
    else:
        raise ValueError(f"unsupported task {task!r}")
    return trainer, trainer.init_state(0)


def sample_shape(task: str, batch: int, img_size: int) -> tuple[int, ...]:
    """The serving input's NHWC shape: ``img_size`` squares for age, the
    228x304 crop for NYUD2."""
    hw = (img_size, img_size) if task == "age" else NYUD2_HW
    return (batch, *hw, 3)


def default_input_dtype(task: str) -> np.dtype:
    """uint8 for age (cast and normalized in the graph, 4x fewer bytes to
    the device), float32 for NYUD2."""
    return np.dtype("uint8" if task == "age" else "float32")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("checkpoint", nargs="?", help="store dir holding latest.pt / best.pt")
    p.add_argument("out", nargs="?", help="output artifact path")
    p.add_argument("--task", default="age", choices=["age", "nyud2"])
    p.add_argument("--which", default="best", choices=["best", "latest"])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--platforms", nargs="*", default=["cuda"], choices=["cuda", "cpu"])
    p.add_argument("--input_dtype", default=None, choices=["uint8", "float32"],
                   help="serving input dtype. uint8 (age default) puts the cast and "
                   "normalization in the graph (data/augment.py normalize_only) and sends "
                   "4x fewer bytes to the device than float32 (NYUD2 default)")
    p.add_argument("--load", default="", help="smoke-load an artifact instead")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model is built and restored, and where --load runs")
    args = p.parse_args(argv)
    input_dtype = np.dtype(args.input_dtype) if args.input_dtype else default_input_dtype(args.task)

    if args.load:
        from imbalanced_regression_tpu_torch.serving import load_predictor_file

        predict = load_predictor_file(args.load, args.device)
        aval = predict.data_avals[0]
        x = np.zeros((args.batch, *aval.shape[1:]), aval.dtype)
        y = predict(x)
        print(f"loaded {args.load}: platforms={predict.platforms} device={predict.device} "
              f"in={predict.in_shape} dtype={aval.dtype} out={y.shape}")
        return

    if not (args.checkpoint and args.out):
        p.error("checkpoint and out are required unless --load is given")

    from imbalanced_regression_tpu_torch.serving import export_predictor, save_predictor
    from imbalanced_regression_tpu_torch.utils.checkpoint import restore_checkpoint

    trainer, state = build_task(args.task, {"img_size": args.img_size}
                                if args.task == "age" else {}, args.device)
    state, epoch, best = restore_checkpoint(args.checkpoint, state, which=args.which)
    sample = np.zeros(sample_shape(args.task, args.batch, args.img_size), input_dtype)
    blob = export_predictor(trainer, state, sample, platforms=args.platforms)
    save_predictor(args.out, blob)
    print(f"exported {args.task} (epoch {epoch}, best {best}) for {sample.shape} "
          f"{sample.dtype} on {args.platforms}: {len(blob):,} bytes -> {args.out}")


if __name__ == "__main__":
    main(sys.argv[1:])
