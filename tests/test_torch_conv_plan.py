"""The tiling plan of the fused conv kernel (#5):
``ops/conv_in_stats.py::plan_conv``, on the CPU. At every shape the port's
card runs (``chip_smoke.py``'s fused LUNA shapes, the train batch's stage
0b, the tiny model's fused layers) and at edge shapes: the route, that the
tiles cover every output voxel exactly once, that the K splits cover
``[0, K_pad)`` exactly once in steps of ``BK``, the shared memory and the
split-K workspace."""
import pytest
import torch

import chip_smoke
from nndetection_tpu_torch.ops import conv_in_stats as cis

torch.set_num_threads(1)

# (x shape, Co) -> route on a 132-SM card
ROUTES = {
    # LUNA plan, batch 2: the stem, stages 0b-3 on the brick, 4-5 split-K
    ((2, 96, 128, 128, 1), 32): "im2col",
    ((2, 96, 128, 128, 32), 32): "brick",
    ((2, 48, 64, 64, 64), 64): "brick",
    ((2, 24, 32, 32, 128), 128): "brick",
    ((2, 12, 16, 16, 256), 256): "brick",
    ((2, 6, 8, 8, 320), 320): "split_k",
    ((2, 3, 4, 4, 320), 320): "split_k",
    # the train batch's stage 0b
    ((8, 96, 128, 128, 32), 32): "brick",
    # the tiny model: [2, 16, 16, 16, 16] -> 16 has 14 K steps, too few for
    # two splits of 8, and stays on im2col
    ((2, 32, 32, 32, 1), 8): "im2col",
    ((2, 32, 32, 32, 8), 8): "im2col",
    ((2, 16, 16, 16, 16), 16): "im2col",
    ((2, 8, 8, 8, 32), 32): "split_k",
    ((2, 4, 4, 4, 64), 64): "split_k",
    # edges
    ((1, 16, 32, 8, 64), 64): "split_k",
    ((1, 3, 16, 16, 32), 32): "split_k",
    ((2, 8, 16, 32, 32), 320): "brick",
    ((1, 8, 16, 16, 1), 32): "im2col",
    ((1, 8, 16, 16, 8), 16): "im2col",
    ((1, 8, 16, 32, 16), 32): "im2col",
    ((8, 2, 64, 64, 32), 32): "brick",
    ((2, 16, 32, 64, 64), 16): "brick",
    ((1, 4, 8, 16, 320), 64): "split_k",
    # stages 3-5 at batch 1 and 8
    ((1, 12, 16, 16, 256), 256): "split_k",
    ((8, 6, 8, 8, 320), 320): "split_k",
    ((8, 3, 4, 4, 320), 320): "split_k",
}


def tile_voxels(p, mt):
    """The flat voxel indices (within one batch item) of the rows of m tile
    ``mt`` that exist, in row order, as the kernel decodes them
    (``conv3d_brick_kernel``'s brick origin and ``row_voxel``;
    ``voxel_of`` on the other routes)."""
    _, d, h, w, _ = p.x_shape
    r = torch.arange(p.bm)
    if p.route != "brick":
        m = mt * p.bm + r
        return m[m < d * h * w]
    bw, bh = w // cis.BRICK_W, h // p.th
    w0, h0, d0 = (mt % bw) * cis.BRICK_W, (mt // bw) % bh * p.th, mt // (bw * bh) * p.td
    run = r // cis.BRICK_W
    return ((d0 + run // p.th) * h + h0 + run % p.th) * w + w0 + r % cis.BRICK_W


def k_ranges(p):
    """``[k_begin, k_end)`` of each split in K elements, as the kernel takes
    them: steps ``[s * k_steps, min((s + 1) * k_steps, n_k))``."""
    n_k = cis.k_pad(p.x_shape[4]) // cis.BK
    return [(s * p.k_steps * cis.BK, min(n_k, (s + 1) * p.k_steps) * cis.BK)
            for s in range(p.splits)]


def test_every_smoke_shape_is_pinned():
    shapes = (chip_smoke.CONV_SHAPES + [chip_smoke.CONV_TRAIN] + chip_smoke.TINY_FUSED_LAYERS
              + chip_smoke.CONV_EDGE_SHAPES)
    assert set(shapes) <= set(ROUTES)


@pytest.mark.parametrize("xs,co", list(ROUTES))
def test_plan(xs, co):
    p = cis.plan_conv(xs, co)
    b, d, h, w, ci = xs
    n_voxels = d * h * w
    # the route
    assert p.route == ROUTES[(xs, co)]
    assert p.bn == (64 if co % 64 == 0 else 32) and p.bm * p.bn == 8192
    assert p.n_tiles * p.bn >= co > (p.n_tiles - 1) * p.bn
    if p.route == "brick":
        assert p.blocks >= 132 and ci % 32 == 0 and w % 16 == 0
        assert p.td * p.th * 16 == p.bm and d % p.td == 0 and h % p.th == 0
    elif p.route == "split_k":
        assert ci % 8 == 0 and p.splits > 1 and p.n_tiles * p.m_tiles * b < 132
        # the grid reaches two blocks per SM, or the splits are as short as
        # allowed
        assert (p.blocks >= cis.SPLIT_BLOCKS_PER_SM * 132
                or p.k_steps < 2 * cis.MIN_SPLIT_STEPS)
    else:
        assert p.splits == 1
    # the tiles cover every output voxel exactly once
    rows = torch.cat([tile_voxels(p, mt) for mt in range(p.m_tiles)])
    assert rows.numel() == n_voxels
    assert torch.equal(rows.sort().values, torch.arange(n_voxels))
    if p.route == "brick":  # bricks hold BM voxels each: the combine's count
        assert p.m_tiles * p.bm == n_voxels
    # the K splits cover [0, K_pad) exactly once, in steps of BK
    k_pad = -(-27 * ci // cis.BK) * cis.BK
    ranges = k_ranges(p)
    assert len(ranges) == p.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k_pad
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1
    for k0, k1 in ranges:
        assert k0 % cis.BK == 0 and k1 % cis.BK == 0 and k1 > k0
        if p.route == "split_k":
            assert (k1 - k0) // cis.BK >= cis.MIN_SPLIT_STEPS
    # shared memory: within one block's limit; the brick's voxel pitch keeps
    # every shifted fragment row 16-byte aligned (ldmatrix), and the eight
    # rows of one ldmatrix phase in distinct banks
    assert (2 * cis.PITCH) % 16 == 0 and cis.PITCH >= 32
    assert len({(2 * cis.PITCH * i // 16) % 8 for i in range(8)}) == 8
    assert 0 <= p.smem_bytes <= 232_448
    if p.route == "brick":
        nbuf = 2 if ci > 32 else 1
        assert (p.taps, p.stages) == cis.BRICK_PIPELINE[p.bn]
        assert p.smem_bytes >= (nbuf * (p.td + 2) * (p.th + 2) * 18 * cis.PITCH * 2
                                + p.stages * p.taps * cis.BK * (p.bn + 8) * 2)
        assert p.smem_bytes >= p.bm * (p.bn + 4) * 4  # the f32 tile overlays it
    else:  # the im2col kernel's shared memory is static
        assert (p.taps, p.stages, p.smem_bytes) == (0, 0, 0)
    # the split-K workspace: [splits, B, m_tiles * BM, n_tiles * BN] float32
    if p.route == "split_k":
        assert p.ws_bytes == p.splits * b * p.m_tiles * p.bm * p.n_tiles * p.bn * 4
        assert p.ws_bytes >= p.splits * b * n_voxels * co * 4
    else:
        assert p.ws_bytes == 0


def test_stage4_train_batch_workspace():
    """Stage 4 at the train batch: 120 im2col blocks, three splits of 90 K
    steps, an 11.8 MB workspace."""
    p = cis.plan_conv((8, 6, 8, 8, 320), 320)
    assert (p.splits, p.k_steps, p.blocks, p.ws_bytes) == (3, 90, 360, 11_796_480)


@pytest.mark.parametrize("pipeline", cis.BRICK_PIPELINES)
@pytest.mark.parametrize("xs,co", [((8, 96, 128, 128, 32), 32), ((2, 12, 16, 16, 256), 256)])
def test_brick_pipelines_fit(xs, co, pipeline):
    """Every brick pipeline fits one block's shared memory at stages 0b-3;
    the default one leaves room for three blocks per SM at stage 0b
    (32-channel tiles, one halo brick) and two at the 64-channel tiles."""
    p = cis.plan_conv(xs, co, brick_pipeline=pipeline)
    assert p.route == "brick" and (p.taps, p.stages) == pipeline
    assert p.smem_bytes <= 232_448 - cis.SMEM_STATIC
    if pipeline == cis.BRICK_PIPELINE[p.bn]:
        blocks = 3 if p.bn == 32 else 2
        assert blocks * (p.smem_bytes + cis.SMEM_STATIC) <= 228 * 1024


def test_unknown_brick_pipeline_raises():
    with pytest.raises(ValueError):
        cis.plan_conv((8, 96, 128, 128, 32), 32, brick_pipeline=(2, 2))


def test_more_sms_more_splits():
    small = cis.plan_conv((2, 3, 4, 4, 320), 320, n_sms=132)
    large = cis.plan_conv((2, 3, 4, 4, 320), 320, n_sms=264)
    assert large.splits > small.splits and large.blocks > small.blocks


@pytest.mark.parametrize("xs,co,route", [
    ((2, 96, 128, 128, 1), 32, "brick"),      # Ci = 1
    ((2, 96, 128, 128, 1), 32, "split_k"),    # Ci % 8 != 0
    ((1, 16, 32, 8, 64), 64, "brick"),        # W = 8
])
def test_forced_route_the_shape_cannot_take_raises(xs, co, route):
    with pytest.raises(ValueError):
        cis.plan_conv(xs, co, route=route)


def test_forced_routes():
    xs, co = (2, 24, 32, 32, 128), 128
    assert cis.plan_conv(xs, co, route="im2col").route == "im2col"
    small = (1, 8, 16, 32, 32)  # 8 blocks: the brick only when forced
    assert cis.plan_conv(small, 32).route == "split_k"
    forced = cis.plan_conv(small, 32, route="brick")
    assert forced.route == "brick" and (forced.td, forced.th) == (4, 4)
