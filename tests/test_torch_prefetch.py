"""``TrainingPipeline.prefetch`` (the port's threaded prefetch, in place of
the JAX package's ``jax.device_put`` queue), on the CPU with
``tests/test_train.py``'s tiny dataset: the order and content of its
batches, its sample threads, a data-parallel rank's rows, errors raised in
the consumer, and its threads ending when the consumer stops."""

import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu_torch.data.dataset import SourceDataset
from caesar_mrcnn_tpu_torch.data.generator import TrainingPipeline
from caesar_mrcnn_tpu_torch.parallel.mesh import shard_rows
from torch_train_fixtures import tiny_config, tiny_dataset

# the sample's keys that depend on the image alone (the RPN targets sample
# anchors from the thread's RandomState)
DETERMINISTIC = ("images", "image_meta", "gt_class_ids", "gt_boxes", "gt_masks_packed")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return tiny_dataset(tmp_path_factory.mktemp("data"))


@pytest.fixture(scope="module")
def dataset8(tmp_path_factory):
    """The tiny dataset's four images listed twice: eight image ids, so
    that a global batch of four holds half of an epoch."""
    tmp = tmp_path_factory.mktemp("data8")
    tiny_dataset(tmp)
    ds = SourceDataset()
    ds.set_class_dict({"sidelobe": 1, "source": 2, "galaxy": 3})
    for _ in range(2):
        assert ds.load_data_from_list(str(tmp / "list.dat")) == 0
    ds.prepare()
    assert len(ds.image_ids) == 8
    return ds


def _take(it, n, timeout=60.0):
    """``n`` batches of ``it``, read in a daemon thread; fails when they do
    not all come within ``timeout`` (a rank whose threads are fed no id
    would wait for ever)."""
    out = []

    def read():
        for _ in range(n):
            out.append(next(it))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(timeout)
    assert not reader.is_alive() and len(out) == n, f"{len(out)} of {n} batches within {timeout} s"
    return out


def _threads_end(before, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not [t for t in threading.enumerate() if t not in before and t.is_alive()]:
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("num_workers,device", [(0, None), (1, None), (1, "cpu")])
def test_prefetch_yields_the_batches_in_order(dataset, num_workers, device):
    """With at most one worker, the batches of ``batches()`` from the same
    seed, in order; with a device, as tensors on it."""
    cfg = tiny_config()
    ref = TrainingPipeline(dataset, cfg, seed=3).batches()
    before = set(threading.enumerate())
    it = TrainingPipeline(dataset, cfg, seed=3, num_workers=num_workers, max_queue=2).prefetch(device=device)
    for _ in range(5):
        want, got = next(ref), next(it)
        assert got.keys() == want.keys()
        for k in want:
            if device is None:
                assert isinstance(got[k], np.ndarray) and got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                assert isinstance(got[k], torch.Tensor) and got[k].device.type == device
                np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    it.close()
    assert _threads_end(before)


def test_prefetch_workers_make_every_sample(dataset):
    """Three sample threads, 16 samples (four epochs of the four images):
    each equals, in its image-only keys, the sample ``make_sample`` makes
    of its image. The threads take the ids in the feeder's order (the
    pipeline's seeded shuffles, drawn after the threads' seeds) and hold
    at most one each, so the 16 samples are the first 16 ids fed but at
    most 3, made up from the next 3."""
    cfg = tiny_config()
    pipe = TrainingPipeline(dataset, cfg, seed=3, num_workers=3)
    want = {int(i): pipe.make_sample(i, rng=np.random.RandomState(0)) for i in dataset.image_ids}
    twin = TrainingPipeline(dataset, cfg, seed=3)
    twin.rng.randint(2 ** 31, size=3)
    stream = twin._id_stream()
    fed = [int(next(stream)) for _ in range(19)]
    before = set(threading.enumerate())
    it = pipe.prefetch()
    samples = []
    for _ in range(8):
        batch = next(it)
        samples += [{k: v[j] for k, v in batch.items()} for j in range(cfg.batch_size)]
    it.close()
    ids = [int(s["image_meta"][0]) for s in samples]
    assert len(ids) == 16
    assert not Counter(ids) - Counter(fed), (ids, fed)
    assert sum((Counter(fed[:16]) - Counter(ids)).values()) <= 3, (ids, fed)
    for s in samples:
        ref = want[int(s["image_meta"][0])]
        for k in DETERMINISTIC:
            np.testing.assert_array_equal(s[k], ref[k], err_msg=k)
    assert _threads_end(before)


@pytest.mark.parametrize("num_workers", [0, 3])
def test_prefetch_raises_a_failing_sample_in_the_consumer(dataset, num_workers, monkeypatch):
    """Samples that keep failing exhaust the skip budget (6 in a row); the
    error is raised by the iterator, and every thread ends."""
    pipe = TrainingPipeline(dataset, tiny_config(), seed=3, num_workers=num_workers)

    def broken(image_id, rng=None):
        raise OSError(f"cannot read image {image_id}")

    monkeypatch.setattr(pipe, "make_sample", broken)
    before = set(threading.enumerate())
    with pytest.raises(OSError, match="cannot read image"):
        next(pipe.prefetch())
    assert _threads_end(before)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_prefetch_rows_of_two_ranks_make_the_global_batches(dataset8, num_workers):
    """Two data-parallel ranks' ``prefetch(rows=...)`` (global batch 4, two
    rows each, pipelines of one seed) make the one-process pipeline's
    global batches between them. With one thread, the rows of
    ``batches()``'s, exactly. With two sample threads, each rank's samples
    are the images at its rows' positions of the shuffled id stream (the
    ids after the threads' seeds, as above), up to the threads' order: at
    most two of the first six batches' ids taken from the seventh's."""
    cfg = tiny_config(images_per_device=2, num_devices=2)
    bs, n = cfg.batch_size, 6
    ranks = []
    for r in range(2):
        before = set(threading.enumerate())
        it = TrainingPipeline(dataset8, cfg, seed=3, num_workers=num_workers).prefetch(rows=shard_rows(bs, 2, r))
        ranks.append(_take(it, n))
        it.close()
        assert _threads_end(before)
    if num_workers <= 1:
        ref = TrainingPipeline(dataset8, cfg, seed=3).batches()
        for k in range(n):
            want = next(ref)
            for key in want:
                np.testing.assert_array_equal(np.concatenate([ranks[0][k][key], ranks[1][k][key]]), want[key],
                                              err_msg=key)
        return
    twin = TrainingPipeline(dataset8, cfg, seed=3)
    twin.rng.randint(2 ** 31, size=num_workers)
    stream = twin._id_stream()
    fed = [int(next(stream)) for _ in range(bs * (n + 1))]
    for r, batches in enumerate(ranks):
        rows = shard_rows(bs, 2, r)
        mine = [fed[k * bs + j] for k in range(n + 1) for j in range(rows.start, rows.stop)]
        ids = [int(i) for b in batches for i in b["image_meta"][:, 0]]
        assert len(ids) == n * 2
        assert not Counter(ids) - Counter(mine), (r, ids, mine)
        assert sum((Counter(mine[: n * 2]) - Counter(ids)).values()) <= num_workers, (r, ids, mine)
