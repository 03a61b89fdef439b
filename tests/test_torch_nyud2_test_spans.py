"""The NYUD2 driver's test pass (``tasks/nyud2.py`` ``test_epoch``) as the
port's span recorder sees it: one ``test`` span of the trainer's epoch,
holding each batch's ``upsample`` and ``shot_metrics`` spans and the final
scoring's ``shot_metrics`` span; and the pass's metrics the same with
recording on, with it off, and computed by hand without any span.

This file imports neither jax nor the JAX package."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imbalanced_regression_tpu_torch.data.batching import eval_batches
from imbalanced_regression_tpu_torch.tasks import nyud2
from imbalanced_regression_tpu_torch.utils.logging_tools import recorder
from imbalanced_regression_tpu_torch.utils.metrics import DepthEvaluator

IMAGES, BATCH, EPOCH = 5, 2, 3  # 3 test batches, the last padded
IMG_HW = (64, 96)  # the model predicts at half the image size


@pytest.fixture(autouse=True)
def _few_threads_and_recording_on():
    before, enabled = torch.get_num_threads(), recorder.enabled
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
    recorder.enabled = enabled


def _trainer_and_test():
    config = nyud2.NYUDConfig(fds=True, lds=True, reweight="inverse", device="cpu",
                              stage_sizes=(1, 1, 1, 1), width=8, batch_size=BATCH)
    trainer = nyud2.build_nyud_trainer(config)
    state = trainer.init_state(0)
    rng = np.random.default_rng(0)
    train = {"input": rng.integers(0, 256, (BATCH, *IMG_HW, 3), dtype=np.uint8),
             "target": rng.uniform(0.7, 10.0, (BATCH, 32, 48, 1)).astype(np.float32)}
    state = trainer.fds_epoch_pass(state, iter([train]), EPOCH)  # the trainer's epoch
    test = {"input": rng.integers(0, 256, (IMAGES, *IMG_HW, 3), dtype=np.uint8),
            "target": rng.uniform(0.7, 10.0, (IMAGES, *IMG_HW, 1)).astype(np.float32),
            "mask": rng.random((IMAGES, *IMG_HW)) < 0.3}
    return trainer, state, test


def test_test_epoch_records_its_spans():
    trainer, state, test = _trainer_and_test()
    nyud2.test_epoch(trainer, state, test, BATCH)
    spans = recorder.closed("test", "upsample", "shot_metrics", trainer=trainer.trace_id)
    outer = [s for s in spans if s.name == "test"]
    assert len(outer) == 1 and outer[0] is spans[-1] and outer[0].parent is None
    inner = spans[:-1]
    # each batch: its upsample, then its mask and accumulation; then the scoring
    assert [s.name for s in inner] == ["upsample", "shot_metrics"] * 3 + ["shot_metrics"]
    assert [s.rows for s in inner] == [2, 2, 2, 2, 1, 1, -1]
    assert all(s.parent is outer[0] for s in inner)
    assert all(s.trainer == trainer.trace_id and s.epoch == EPOCH for s in spans)
    assert all(outer[0].start_ns <= s.start_ns <= s.end_ns <= outer[0].end_ns for s in inner)


def _by_hand(trainer, state, test):
    """The seed's pass without spans: predictions, the bilinear upsample to
    the depth's size, the balanced mask, the shot metrics."""
    evaluator = DepthEvaluator()
    offset = 0
    for batch in eval_batches({k: v for k, v in test.items() if k != "mask"}, BATCH):
        count = batch.pop("count")
        pred = trainer.predict_batch(state, batch, count)
        pred = F.interpolate(torch.from_numpy(pred).permute(0, 3, 1, 2), size=IMG_HW,
                             mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
        m = test["mask"][offset:offset + count][..., None]
        evaluator(pred[m], test["target"][offset:offset + count][m])
        offset += count
    return evaluator.evaluate_shot()


def test_test_epoch_metrics_unchanged_by_the_spans():
    trainer, state, test = _trainer_and_test()
    on = nyud2.test_epoch(trainer, state, test, BATCH)
    recorder.enabled = False
    off = nyud2.test_epoch(trainer, state, test, BATCH)
    recorder.enabled = True
    # equal entry by entry, NaN for NaN (LG10 of a negative prediction)
    np.testing.assert_equal(on, off)
    np.testing.assert_equal(on, _by_hand(trainer, state, test))
    assert on["overall"]["NUM"] == int(test["mask"].sum())
