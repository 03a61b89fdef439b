"""Phase 14 of ``chip_smoke.py`` (serving) alone, on one NVIDIA GPU (H100),
without the training phases whose stores it serves:

    python3 serve_probe.py

Writes fresh-init checkpoints (weights from seed 0, no training) into the
stores phases 8, 10 and 11 would write (the age path's ResNet-50, the NYUD2
encoder-decoder and, after ``write_sts_corpus``, the full-width STS-B
encoder), then runs ``chip_smoke.serving_phase`` on them: the three
predictors exported, held against ``predict_batch`` and timed, and
``tools/serve_bench.py`` at batches 1-128. Prints the card's name and power
limit first. Exits non-zero with no CUDA device. The stores and the corpus
are deleted at the end.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import torch

import chip_smoke as cs

ROOT = "runs/serve_probe"


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from imbalanced_regression_tpu_torch.data.stsb import load_stsb_datasets
    from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
    from imbalanced_regression_tpu_torch.tasks import age, nyud2, stsb
    from imbalanced_regression_tpu_torch.train import set_numerics
    from imbalanced_regression_tpu_torch.utils.checkpoint import save_checkpoint
    from imbalanced_regression_tpu_torch.utils.config import parse_config

    set_numerics()
    t0 = time.time()
    cs.write_sts_corpus()
    sts_argv = cs.STS_ARGV + ["--store_root", f"{ROOT}/sts"]
    scfg = stsb.parse_sts_config(sts_argv)
    _, _, _, emb, vocab = load_stsb_datasets(scfg.data_dir, scfg)
    stores = []
    for config, build in (
            (parse_config(cs.AGE_RESUME_ARGV + ["--store_root", f"{ROOT}/age"]), age.build_trainer),
            (nyud2.parse_nyud_config(cs.DEPTH_RESUME_ARGV + ["--store_root", f"{ROOT}/depth"]),
             nyud2.build_nyud_trainer),
            (scfg, lambda c: stsb.build_sts_trainer(c, len(vocab), emb))):
        stores.append(cs.store_of(config))
        save_checkpoint(stores[-1], build(config).init_state(0), 1, 1.0, is_best=True)
    print(f"stores written in {time.time() - t0:.1f}s", flush=True)
    records = cs.serving_phase(ck, stores[0], stores[1], sts_argv)
    print(json.dumps({"serving": records}), flush=True)
    shutil.rmtree(ROOT)
    shutil.rmtree(cs.STS_DIR)
    return 0


if __name__ == "__main__":
    sys.exit(main())
