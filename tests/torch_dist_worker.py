"""One rank of the port's multi-process tests (``tests/test_torch_dist.py``).

Not a test file: the tests start it as

    python tests/torch_dist_worker.py <case> <port> <rank> <world size> <directory>

and each rank joins a Gloo group on the CPU (``parallel.dist.init_process_group``,
one thread, an init timeout), runs its case and prints
``<CASE>_<rank>_OK``. It imports the port alone (no jax, nothing of
``caesar_mrcnn_tpu``), so the tests' inputs come from the directory:

* ``comm``: ``TorchDistComm`` through the checks of ``tests/dcn_worker.py``
  (unequal objects; 40,000 against 80,000 pixel rows at ``chunk=4096``;
  gather to rank 0; barrier), and ``get_comm`` with the group initialized;
* ``train``: ``train_inputs.pt`` (config, weights, global batches and, when
  given, the global batches' sampling priorities) through the
  data-parallel train step, this rank's rows of every batch; writes its
  losses, final weights and optimizer state to ``train_rank<r>.pt``;
* ``sfinder <kind> <stem>``: ``SFinder.run_tiled`` over ``mosaic.fits``
  with the fake tile detector of ``tests/test_sfinder.py`` (``fake``) or a
  small detector with pinned heads (``pinned``), rank 0 writing
  ``<stem>.json`` and ``<stem>.reg`` (a group of one runs ``SerialComm``).
"""

import ast
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from caesar_mrcnn_tpu_torch.parallel import dist as D  # noqa: E402
from caesar_mrcnn_tpu_torch.parallel.mesh import shard_batch  # noqa: E402


def check_comm(rank, world, outdir):
    comm = D.get_comm()
    assert isinstance(comm, D.TorchDistComm), type(comm)
    assert comm.size == world and comm.rank == rank
    # unequal-size python objects (the lengths, then the padded payloads)
    obj = {"rank": comm.rank, "dets": [(i, "s" * (11 + comm.rank * 137)) for i in range(3)]}
    out = comm.allgather(obj)
    assert [o["rank"] for o in out] == [0, 1], out
    assert len(out[0]["dets"][0][1]) == 11 and len(out[1]["dets"][0][1]) == 148
    # multi-round chunked exchange: one rank's payload far larger than the chunk
    big = {"rank": comm.rank, "pixels": [[y, y + 1] for y in range(40000 * (1 + comm.rank))]}
    out2 = comm.allgather(big, chunk=4096)
    assert [o["rank"] for o in out2] == [0, 1]
    assert len(out2[0]["pixels"]) == 40000 and len(out2[1]["pixels"]) == 80000
    assert out2[1]["pixels"][-1] == [79999, 80000]
    # gather to rank 0: a list there, None elsewhere
    g = comm.gather(("tile", comm.rank))
    assert g == ([("tile", 0), ("tile", 1)] if comm.rank == 0 else None), g
    comm.barrier()


def run_train(rank, world, outdir):
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from caesar_mrcnn_tpu_torch.train import trainer as TR
    from caesar_mrcnn_tpu_torch.utils.anchors import get_anchors

    inputs = torch.load(os.path.join(outdir, "train_inputs.pt"), weights_only=False)
    cfg = inputs["config"]
    model = MaskRCNN(cfg)
    model.load_state_dict(inputs["state"] if rank == 0 else {k: v + 1.0 for k, v in inputs["state"].items()})
    group = dist.group.WORLD
    TR.broadcast_parameters(model, group)  # rank 1 started elsewhere: it must take rank 0's weights
    optimizer = TR.make_optimizer(cfg, model, "all")
    step = TR.make_train_step(model, optimizer, get_anchors(cfg), group=group)
    generator = torch.Generator().manual_seed(inputs["seed"])
    losses = []
    for k, batch in enumerate(inputs["batches"]):
        local = TR.batch_to_device(shard_batch(batch, world, rank), "cpu")
        if inputs["priorities"] is None:
            out = step(local, generator=generator)
        else:
            out = step(local, priorities=inputs["priorities"][k])
        losses.append({n: float(v) for n, v in out.items()})
    torch.save({"losses": losses, "state": model.state_dict(), "optimizer": optimizer.state_dict()},
               os.path.join(outdir, f"train_rank{rank}.pt"))


def fake_tile_detector(cfg):
    """``tests/test_sfinder.py``'s ``FakeTileDetector``, its classes taken
    from the test's source (the module imports the JAX package)."""
    from scipy import ndimage

    tree = ast.parse((REPO / "tests" / "test_sfinder.py").read_text())
    classes = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name in ("FakeDetector", "FakeTileDetector")]
    namespace = {"np": np, "ndimage": ndimage}
    exec(compile(ast.Module(body=classes, type_ignores=[]), "test_sfinder.py", "exec"), namespace)
    return namespace["FakeTileDetector"](cfg)


def run_sfinder(rank, world, outdir, kind, stem):
    from caesar_mrcnn_tpu_torch.analysis.sfinder import SFinder

    cfg, det = sfinder_detector(kind)
    sf = SFinder(det, cfg)
    assert sf.comm.size == world and isinstance(sf.comm, D.TorchDistComm if world > 1 else D.SerialComm)
    sf.outfile_json, sf.outfile_ds9 = os.path.join(outdir, f"{stem}.json"), os.path.join(outdir, f"{stem}.reg")
    sources = sf.run_tiled(os.path.join(outdir, "mosaic.fits"))
    assert (rank == 0) == bool(sources)


def sfinder_detector(kind):
    """(config, detector) of an SFinder case."""
    from caesar_mrcnn_tpu_torch.config import detector_config, inference_config
    from caesar_mrcnn_tpu_torch.inference.detector import build_detector
    from caesar_mrcnn_tpu_torch.testing import pin_heads

    names = ("bkg", "sidelobe", "source", "galaxy")
    if kind == "fake":
        cfg = detector_config(num_classes=4, class_names=names, score_thr=0.5, images_per_device=2, num_devices=1,
                              tile_xsize=128, tile_ysize=128, image_min_dim=128, image_max_dim=128,
                              split_img_in_tiles=True)
        return cfg, fake_tile_detector(cfg)
    cfg = inference_config(detector_config(
        backbone="custom", image_min_dim=128, image_max_dim=128, num_classes=4, class_names=names,
        images_per_device=1, pre_nms_limit=256, post_nms_rois_inference=64, detection_max_instances=16,
        compute_dtype="float32", tile_xsize=128, tile_ysize=128, split_img_in_tiles=True))
    det = build_detector(cfg, seed=0, device="cpu")
    pin_heads(det.model)
    return cfg, det


def main():
    case, port, rank, world, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
    torch.set_num_threads(1)
    assert D.init_process_group(rank, world, "cpu", port=port, timeout_s=60.0) == "gloo"
    try:
        {"comm": check_comm, "train": run_train, "sfinder": run_sfinder}[case](rank, world, outdir, *sys.argv[6:])
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "caesar_mrcnn_tpu"))
        assert not loaded, loaded
    finally:
        dist.destroy_process_group()
    print(f"{case.upper()}_{rank}_OK", flush=True)


if __name__ == "__main__":
    main()
