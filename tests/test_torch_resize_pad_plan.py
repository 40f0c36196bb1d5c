"""K1's launch plan (``sykepic_tpu_torch/ops/resize_pad.py::plan``) on the
CPU: the store path it picks for aligned and unaligned outputs, tile rows
and shared bytes within an H100 block's 227 KB for every target width up to
``_MAX_TARGET_W``, and a raise for what the kernel cannot take. The kernel
itself (``csrc/resize_pad.cu``) checks the same plan on the card
(``tests/test_torch_gpu.py``); nothing here needs nvcc or a card.
"""

import pytest
import torch

from sykepic_tpu_torch.ops import resize_pad

F32, BF16 = torch.float32, torch.bfloat16


def _tile_bytes(p, target_w, chans, dtype):
    return p.tile_rows * target_w * chans * torch.empty(
        (), dtype=dtype).element_size()


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("out_ptr", [0, 512, 4096 + 16])
def test_aligned_output_takes_bulk_stores(dtype, out_ptr):
    p = resize_pad.plan(180, 180, 3, dtype, out_ptr)
    assert p.store == "bulk"
    # a staged tile is one bulk store: a multiple of 16 bytes, exactly
    assert p.stage_bytes == _tile_bytes(p, 180, 3, dtype)
    assert p.stage_bytes % 16 == 0


@pytest.mark.parametrize("dtype,out_ptr", [(F32, 4), (F32, 8), (F32, 12),
                                           (BF16, 2), (BF16, 6), (BF16, 14)])
def test_unaligned_output_takes_the_vector_path(dtype, out_ptr):
    p = resize_pad.plan(180, 180, 3, dtype, out_ptr)
    assert p.store == "vector"
    # room to stage the span at its address's offset mod 16
    assert p.stage_bytes >= _tile_bytes(p, 180, 3, dtype) + 16


@pytest.mark.parametrize("target,chans,dtype,store", [
    ((180, 180), 3, F32, "bulk"), ((180, 180), 3, BF16, "bulk"),
    ((180, 180), 1, F32, "bulk"),
    # 179 x 3 bf16 is 1,074 bytes a row: a slot is not a multiple of 16
    ((180, 179), 3, BF16, "vector"), ((180, 179), 3, F32, "bulk"),
    ((97, 33), 3, F32, "vector"), ((100, 33), 3, F32, "bulk"),
])
def test_slot_span_decides_the_store(target, chans, dtype, store):
    p = resize_pad.plan(*target, chans, dtype, 0)
    assert p.store == store
    if store == "bulk":
        assert _tile_bytes(p, target[1], chans, dtype) % 16 == 0


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_the_pointer_counts_only_by_its_alignment(dtype):
    # plans are kept, so a launch pays for one once a shape
    for bright, norm in ((False, False), (True, True)):
        p = resize_pad.plan(180, 180, 3, dtype, 0, bright=bright, norm=norm)
        assert resize_pad.plan(180, 180, 3, dtype, 1 << 40, bright=bright,
                               norm=norm) is p
        q = resize_pad.plan(180, 180, 3, dtype, 2, bright=bright, norm=norm)
        assert resize_pad.plan(180, 180, 3, dtype, 4098, bright=bright,
                               norm=norm) is q
        assert (p.store, q.store) == ("bulk", "vector")


@pytest.mark.parametrize("target_w", [1, 2, 33, 179, 180, 181, 256, 512,
                                      1000, 1024, 2047, 2048])
@pytest.mark.parametrize("chans,dtype", [(1, F32), (3, F32), (3, BF16),
                                         (8, F32), (8, BF16)])
@pytest.mark.parametrize("bright,norm", [(False, False), (True, False),
                                         (True, True)])
def test_plan_fits_the_shared_memory_budget(target_w, chans, dtype, bright,
                                            norm):
    for out_ptr in (0, 2):
        p = resize_pad.plan(180, target_w, chans, dtype, out_ptr,
                            bright=bright, norm=norm)
        assert 0 < p.smem_bytes <= 232_448
        assert p.tile_rows >= 1
        # a thread makes four adjacent columns of every lanes-th row
        assert p.threads % p.lanes == 0 and p.threads <= 256
        assert p.threads // p.lanes == min(-(-target_w // 4), 256)
        tile = _tile_bytes(p, target_w, chans, dtype)
        # tiles fill about 16 KB (rounded to whole lanes), or a few rows
        # where a row is larger
        assert tile <= max(2 * resize_pad._STAGE_BYTES,
                           target_w * chans * 4 * 16)
        extra = 0 if p.store == "bulk" else 16
        assert p.stage_bytes >= tile + extra and p.stage_bytes % 16 == 0
        # the taps of every column and of the slot's rows
        assert p.smem_bytes >= 2 * p.stage_bytes + 16 * (target_w + 180)


def test_tile_rows_are_no_more_than_a_slot_needs():
    p = resize_pad.plan(4, 16, 1, F32, 0)
    assert p.tile_rows == 4


@pytest.mark.parametrize("args", [
    (180, 2048, 16, F32),  # two staged rows of 128 KB: past the budget
    (180, 2049, 3, F32),  # past _MAX_TARGET_W
    (20_000, 180, 3, F32),  # the taps of 20,000 rows: 320 KB
    (180, 180, 3, torch.float16),
    (180, 180, 0, F32),
    (0, 180, 3, F32),
])
def test_plan_raises_for_what_the_kernel_cannot_take(args):
    with pytest.raises(ValueError):
        resize_pad.plan(*args, 0)


def test_cpu_tensors_take_the_plain_version_whatever_the_plan():
    # the plan is for the card; on the CPU the wrapper runs the plain
    # version and counts no launch
    pix = torch.zeros((1, 8, 8), dtype=torch.uint8)
    meta = torch.tensor([[0], [0], [0], [8], [8], [180], [180], [0], [0],
                         [7]], dtype=torch.int32)
    # an output one element into its buffer: the vector path on the card
    out = torch.empty(180 * 180 * 3 + 1)[1:].view(1, 180, 180, 3)
    before = (resize_pad.launches, resize_pad.vector_launches)
    got = resize_pad.resize_pad(pix, meta, 180, 180, 3, out=out)
    assert (resize_pad.launches, resize_pad.vector_launches) == before
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, torch.full((1, 180, 180, 3), 0.0))
