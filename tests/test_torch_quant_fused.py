"""The int8 graph's Hopper kernel plan and fused quantizers, on the CPU:

* ``ops/quant.py::conv_plan`` over the serving flagship's 123 sites (the
  stem with its channels padded to 16): a tile width of 64, 128 or 256, a
  split of K in whole shares, and the sites whose output tiles alone would
  not fill the card's 132 SMs filled;
* ``ops/quant.py::hopper_operands``: Cin padded to 16 and unaligned
  operands copied, the int32 sums unchanged, and the serving sites'
  operands passed through with no copy;
* the ``then`` map of the stages' walk: exactly the 70 convolutions whose
  output one quantized convolution alone reads;
* the fused plain path (``quantize_int8_plain(conv2d_int8_plain(...))``
  inside the producer's call) equal to the unfused one and to the JAX
  package's ``resnet_int8`` on one tree, bit for bit, with 17 quantizer
  passes in place of 41;
* the stem's padding: the same int32 sums as ``lax.conv_general_dilated``
  on the unpadded image, and the padded quantizer equal to ``jnp``'s;
* ``kernel_bench.conv_int8_bound`` counting one byte per output where a
  site requantizes;
* the plan's tile sizes equal to the kernel's own constants, its waves
  counted over the card's SMs, and every edit of
  ``tools/conv_int8_variants.py`` still applying to the kernel's source.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu.models import backbone_int8 as JBQ
from caesar_mrcnn_tpu_torch import kernel_bench as kb
from caesar_mrcnn_tpu_torch.config import detector_config
from caesar_mrcnn_tpu_torch.models import backbone_int8 as BQ
from caesar_mrcnn_tpu_torch.ops import quant as Q
from caesar_mrcnn_tpu_torch.weights import qtree_to_torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("conv_int8_variants", ROOT / "tools" / "conv_int8_variants.py")
variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(variants)

SERVING = dict(num_classes=4, image_min_dim=512, image_max_dim=512, images_per_device=8,
               compute_dtype="bfloat16", quant_mode="int8", pre_nms_limit=3000, post_nms_rois_inference=512)
# the sites whose 128 x 128 output tiles number under half the card's SMs
SMALL_GRID = {f"bb/res5{b}/conv{i}" for b in "abc" for i in (1, 2)} | {"fpn/c5p5", "fpn/p5", "rpn/shared@p5",
                                                                        "rpn/shared@p6"}


@pytest.fixture(scope="module")
def sites():
    return kb.int8_sites(detector_config(**SERVING), 512, 100)


def test_conv_plan_over_the_serving_sites(sites):
    assert len(sites) == 123
    small = set()
    for s in sites:
        cin = Q.padded_channels(s.cin)
        kdim = s.k * s.k * cin
        plan = Q.conv_plan(s.m, s.cout, kdim)
        assert plan.bn in Q.TILE_N and 1 <= plan.splits <= Q.MAX_SPLITS, s.name
        nk = -(-kdim // Q.TILE_K)
        kps = -(-nk // plan.splits)
        assert -(-nk // kps) == plan.splits and (plan.splits == 1 or kps >= 2), s.name
        assert plan.bn <= 64 or s.cout > plan.bn // 2, s.name
        tiles = -(-s.m // Q.TILE_M) * -(-s.cout // plan.bn)
        if -(-s.m // 128) * -(-s.cout // 128) < Q.SMS // 2:
            small.add(s.name)
            assert tiles * plan.splits >= 96, (s.name, plan)
        elif plan.splits > 1:
            raise AssertionError(f"{s.name} splits K on a grid that fills the card: {plan}")
    assert small == SMALL_GRID
    stem = sites[0]
    assert (stem.name, Q.padded_channels(stem.cin) * 49) == ("bb/conv1", 784)
    assert Q.conv_plan(stem.m, 64, 784) == Q.ConvPlan(64, 1)  # the padded stem: 4096 tiles fill the card unsplit
    assert sum(Q.conv_plan(s.m, s.cout, s.k * s.k * Q.padded_channels(s.cin)).splits > 1 for s in sites) >= 8


def test_then_names_the_70_single_consumer_sites(sites):
    fused = {s.name: s.then for s in sites if s.then}
    blocks = {s.name.rsplit("/", 1)[0] for s in sites if s.name.startswith("bb/res")}
    want = {f"{b}/conv1": f"{b}/conv2" for b in blocks}
    want.update({f"{b}/conv2": f"{b}/conv3" for b in blocks})
    want.update({"cls/conv1": "cls/conv2", "mask/conv1": "mask/conv2", "mask/conv2": "mask/conv3",
                 "mask/conv3": "mask/conv4"})
    assert len(blocks) == 33 and len(fused) == 70 and fused == want
    order = [s.name for s in sites]
    by_name = {s.name: s for s in sites}
    for producer, consumer in fused.items():
        assert order.index(consumer) == order.index(producer) + 1
        assert by_name[consumer].cin == by_name[producer].cout
    assert len(sites) - len(fused) == 53  # quantizer passes per batch


def test_conv_int8_bound_counts_a_byte_where_a_site_requantizes(sites):
    by_name = {s.name: s for s in sites}
    s = by_name["bb/res4b/conv1"]
    assert s.then == "bb/res4b/conv2" and (s.m, s.cout, s.kdim) == (8192, 256, 1024)
    ms, by = kb.conv_int8_bound(s)
    assert by == "bytes" and ms == pytest.approx((8192 * 1024 + 256 * 1024 + 8192 * 256) / 3.35e12 * 1e3)
    unfused = sum(kb.conv_int8_bound(x._replace(then=None))[0] for x in sites)
    fused = sum(kb.conv_int8_bound(x)[0] for x in sites)
    assert unfused == pytest.approx(1.8225, abs=1e-4) and fused < unfused


def _narrow_qtree(seed=0):
    """A quantized tree for the custom backbone at narrow widths (stem 3 ->
    16; bottlenecks 8 / 16 wide, out 16, 32, 32, 48), numpy, the JAX
    package's layout."""
    rs = np.random.RandomState(seed)
    tree = {}

    def site(name, k, cin, cout):
        tree[name] = {"w": rs.randint(-127, 128, (k, k, cin, cout)).astype(np.int8),
                      "sw": rs.uniform(2e-5, 2e-4, cout).astype(np.float32),
                      "b": rs.uniform(-0.3, 0.3, cout).astype(np.float32),
                      "s_in": np.float32(rs.uniform(0.004, 0.012))}

    site("conv1", 7, 3, 16)
    cin = 16
    for blocks, (mid, out) in zip(BQ.stage_blocks("custom"), ((8, 16), (8, 32), (16, 32), (16, 48))):
        for name, project, _ in blocks:
            site(f"{name}/conv1", 1, cin, mid)
            site(f"{name}/conv2", 3, mid, mid)
            site(f"{name}/conv3", 1, mid, out)
            if project:
                site(f"{name}/shortcut", 1, cin, out)
            cin = out
    tree["conv1"]["s_in"] = np.float32(0.9)
    return tree


def test_fused_plain_path_equals_unfused_and_jax(monkeypatch):
    qtree = _narrow_qtree()
    assert len(qtree) == 41
    x = np.random.RandomState(1).uniform(-120, 120, (2, 32, 32, 3)).astype(np.float32)
    calls = []
    quantize = BQ.quantize_int8
    monkeypatch.setattr(BQ, "quantize_int8", lambda *a, **kw: calls.append(a[1]) or quantize(*a, **kw))
    with torch.inference_mode():
        fused = BQ.resnet_int8(qtree, torch.from_numpy(x), "custom", out_dtype=torch.float32)
        n_fused = len(calls)
        convs = BQ.Int8Convs(qtree_to_torch(qtree))
        unfused = BQ.walk_resnet(torch.from_numpy(x), lambda site, y, stride=1, relu=False, then=None:
                                 convs(site, y, stride, relu), "custom")
    assert (n_fused, len(calls) - n_fused) == (41 - 24, 41)
    ref = JBQ.resnet_int8(qtree, jnp.asarray(x), "custom", out_dtype=jnp.float32)
    for f, u, r in zip(fused, unfused, ref):
        assert f.shape == r.shape and f.abs().max() > 0
        np.testing.assert_array_equal(f.numpy(), u.numpy())
        np.testing.assert_array_equal(f.numpy(), np.asarray(r))


def test_fused_call_equals_quantize_of_the_f32_call():
    """conv2d_int8 with s_next on the CPU is the quantizer of its f32
    output: .5 ties and values past +-127 included."""
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randint(-127, 128, (2, 9, 9, 32)).astype(np.int8))
    w = torch.from_numpy(rs.randint(-127, 128, (24, 3, 3, 32)).astype(np.int8))
    sw = torch.full((24,), 2.0 ** -9)
    b = torch.arange(24, dtype=torch.float32) * 0.5 - 6
    pads = Q.xla_pads("SAME", 3, 1, (9, 9))
    y = Q.conv2d_int8(x, w, sw, b, 1, pads, relu=True)
    q = Q.conv2d_int8(x, w, sw, b, 1, pads, relu=True, s_next=0.25)
    assert q.dtype == torch.int8 and torch.equal(q, Q.quantize_int8_plain(y, 0.25))
    r = y / 0.25
    assert ((r - r.floor()) == 0.5).any() and (r > 127).any()


def test_stem_padding_equals_lax_on_the_unpadded_image():
    rs = np.random.RandomState(4)
    img = rs.uniform(-140, 140, (2, 37, 30, 3)).astype(np.float32)
    w = rs.randint(-127, 128, (7, 7, 3, 64)).astype(np.int8)  # HWIO
    xq = Q.quantize_int8(torch.from_numpy(img), 0.875, channels=16)
    ref_q = np.asarray(jnp.clip(jnp.round(jnp.asarray(img) / np.float32(0.875)), -127, 127).astype(jnp.int8))
    assert xq.shape == (2, 37, 30, 16) and not xq[..., 3:].any()
    np.testing.assert_array_equal(xq[..., :3].numpy(), ref_q)
    packed = BQ.pad_input_channels(torch.from_numpy(np.ascontiguousarray(w.transpose(3, 0, 1, 2))))
    assert packed.shape == (64, 7, 7, 16) and not packed[..., 3:].any()
    pads = Q.xla_pads(Q.STEM_PADS, 7, 2, (37, 30))
    got = Q.conv2d_int8_accumulate(xq, packed, 2, pads)
    ref = jax.lax.conv_general_dilated(ref_q, w, (2, 2), [(3, 3), (3, 3)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="multiple of 16"):
        Q.quantize_int8(torch.from_numpy(img), 1.0, channels=20)
    assert torch.equal(Q.quantize_int8(torch.from_numpy(img), 1.0, channels=3),
                       Q.quantize_int8_plain(torch.from_numpy(img), 1.0))


@pytest.mark.parametrize("case", ["Cin 3", "Cin 24", "input 1 byte into its buffer"])
def test_hopper_operands_keep_the_int32_sums(case):
    """The operands as the Hopper kernel takes them (16 | Cin, data on a
    16-byte boundary) give the plain int32 sums of the operands given."""
    rs = np.random.RandomState(len(case))
    cin = {"Cin 3": 3, "Cin 24": 24}.get(case, 32)
    x = torch.from_numpy(rs.randint(-127, 128, (2, 9, 8, cin)).astype(np.int8))
    w = torch.from_numpy(rs.randint(-127, 128, (5, 3, 3, cin)).astype(np.int8))
    if case.startswith("input"):
        buf = torch.empty(x.numel() + 16, dtype=torch.int8)
        offset = (1 - buf.data_ptr()) % 16  # an address one byte past a 16-byte boundary
        x = buf[offset:offset + x.numel()].view(x.shape).copy_(x)
        assert x.data_ptr() % 16 == 1
    xh, wh = Q.hopper_operands(x, w)
    assert xh.shape[-1] == wh.shape[-1] == Q.padded_channels(cin) and xh.shape[:3] == x.shape[:3]
    assert xh.data_ptr() % 16 == wh.data_ptr() % 16 == 0 and xh.is_contiguous() and wh.is_contiguous()
    pads = Q.xla_pads("SAME", 3, 2, (9, 8))
    assert torch.equal(Q.conv2d_int8_accumulate_plain(xh, wh, 2, pads), Q.conv2d_int8_accumulate_plain(x, w, 2, pads))
    assert (wh is w) == (cin == 32) and not xh[..., cin:].any()
    aligned = torch.empty_like(xh).copy_(xh)
    assert all(a is b for a, b in zip(Q.hopper_operands(aligned, wh), (aligned, wh)))  # ready: no copy


def test_plan_tiles_are_the_kernels_constants():
    """TILE_M and TILE_K (the split-K scratch's rows per tile, the stages
    of K the plan counts) are the Hopper kernel's kBM and kBK."""
    src = (ROOT / "caesar_mrcnn_tpu_torch" / "csrc" / "conv_int8.cu").read_text()
    hop = src[src.index("namespace hop {"):]
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (kBM|kBK) = (\d+);", hop)[:2]}
    assert consts == {"kBM": Q.TILE_M, "kBK": Q.TILE_K}


def test_conv_plan_counts_waves_over_the_cards_sms():
    """fpn/c5p5 (32 tiles of 128 x 128, 16 stages of K): split four ways on
    132 SMs, three on a 114-SM card, two on 66."""
    assert [Q.conv_plan(2048, 256, 2048, sms=n).splits for n in (132, 114, 66)] == [4, 3, 2]
    assert Q.conv_plan(2048, 256, 2048) == Q.conv_plan(2048, 256, 2048, sms=Q.SMS)


@pytest.mark.parametrize("name", sorted(variants.VARIANTS))
def test_conv_int8_variant_applies(name):
    """Each edit of the variant matches the kernel's source exactly once."""
    text = variants.variant_source(name)
    assert text.count("namespace hop {") == 1
    assert (text == (ROOT / "caesar_mrcnn_tpu_torch" / "csrc" / "conv_int8.cu").read_text()) == \
        (not variants.VARIANTS[name][0])
