"""The train-step losses of the PyTorch port against the JAX package, at
float32: box encoding and GIoU geometry, every loss function, ATSS and IoU
matching (with the tie case of a GT centred on a grid point), the samplers
with the JAX random draws injected, GT preparation from instance
segmentations, and ``train_step_loss`` over its branches, on random head
outputs and on the tiny model.

Also holds the helpers that ``test_torch_trainer.py`` shares: the JAX
draws in the port's order, and a flax parameter tree of the tiny model made
with NumPy."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nndetection_tpu import losses as JL
from nndetection_tpu.core.boxes import ops as jops
from nndetection_tpu.core.boxes import sampler as jsampler
from nndetection_tpu.core.boxes.coder import BoxCoder as JaxBoxCoder
from nndetection_tpu.core.boxes.matcher import ATSSMatcher as JaxATSS
from nndetection_tpu.core.boxes.matcher import IoUMatcher as JaxIoU
from nndetection_tpu.core.boxes.matcher import gather_matched as j_gather_matched
from nndetection_tpu.data.gt_prep import prepare_targets as j_prepare_targets
from nndetection_tpu.models.retina_unet import train_step_loss as j_train_step_loss
from nndetection_tpu_torch import bridge
from nndetection_tpu_torch import losses as TL
from nndetection_tpu_torch.core.boxes import ops as tops
from nndetection_tpu_torch.core.boxes import sampler as tsampler
from nndetection_tpu_torch.core.boxes.coder import BoxCoder
from nndetection_tpu_torch.core.boxes.matcher import ATSSMatcher, IoUMatcher, gather_matched
from nndetection_tpu_torch.data.gt_prep import prepare_targets
from nndetection_tpu_torch.models.retina_unet import RetinaUNet, train_step_loss
from tests.test_torch_bridge import jax_cfg, torch_cfg

torch.set_num_threads(1)

# losses at float32: the same formulas summed in other orders
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
GEOM_TOL = 1e-6
LOSS_KEYS = ("cls", "reg", "seg_ce", "seg_dice", "num_pos", "num_neg")


def t(a):
    return torch.from_numpy(np.array(a))


def random_boxes(rng, n, lo=0.0, hi=32.0, size=(2.0, 12.0)):
    ctr = rng.uniform(lo + 4, hi - 4, (n, 3))
    half = rng.uniform(*size, (n, 3)) / 2
    b = np.stack([ctr[:, 0] - half[:, 0], ctr[:, 1] - half[:, 1], ctr[:, 0] + half[:, 0],
                  ctr[:, 1] + half[:, 1], ctr[:, 2] - half[:, 2], ctr[:, 2] + half[:, 2]], -1)
    return b.astype(np.float32)


# ------------------------------------------------------------- shared helpers
def jax_draws(key, b: int, n: int, pool_cap: int):
    """The uniform draws of the JAX ``train_step_loss``'s per-image
    ``HardNegativeSamplerBatched`` for ``key``, in the order the port draws
    them: the positives' priorities ``[b, n]``, then the pool's ``[b,
    pool_cap]``."""
    keys = jax.vmap(jax.random.split)(jax.random.split(key, b))  # [b, 2] (kp, kn)
    pos = jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys[:, 0])
    neg = jax.vmap(lambda k: jax.random.uniform(k, (pool_cap,)))(keys[:, 1])
    return [np.asarray(pos), np.asarray(neg)]


def inject_draws(monkeypatch, draws):
    """Make the port's samplers take ``draws`` (NumPy arrays), in order."""
    it = iter(draws)

    def draw(generator, shape, device):
        a = next(it)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(np.array(a)).to(device)

    monkeypatch.setattr(tsampler, "draw_uniform", draw)


def pool_cap(cfg) -> int:
    return jsampler.HardNegativeSamplerBatched(
        batch_size_per_image=cfg.batch_size_per_image, positive_fraction=cfg.positive_fraction,
        min_neg=cfg.min_neg, pool_size=cfg.pool_size).pool_cap


@functools.lru_cache(maxsize=None)
def numpy_params(seed: int = 0, **cfg_overrides):
    """A flax parameter tree of the tiny JAX model (the tree of its ``init``,
    from ``jax.eval_shape``) filled from a NumPy seed: convolution kernels
    he-normal, norm scales near 1, small biases. The classifier's output
    kernel has std 1 (the ``spread`` of the predictor tests): the scores
    spread, so that near-equal scores do not reorder the hard-negative pool
    between the two packages' float32 forwards."""
    from nndetection_tpu.models import RetinaUNet as JaxRetinaUNet

    cfg = jax_cfg(**cfg_overrides)
    x = jax.ShapeDtypeStruct((1, *cfg.patch_size, cfg.in_channels), jnp.float32)
    shapes = jax.eval_shape(JaxRetinaUNet(cfg).init, jax.random.PRNGKey(0), x)
    flat = bridge.flatten_tree(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in sorted(flat.items()):
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":
            std = 1.0 if path.startswith("params/classifier/out/") else np.sqrt(2.0 / np.prod(v.shape[:-1]))
            out[path] = rng.standard_normal(v.shape) * std
        elif leaf in ("scale", "scales"):
            out[path] = 1.0 + 0.1 * rng.standard_normal(v.shape)
        elif path == "params/classifier/out/bias":
            out[path] = np.full(v.shape, -np.log(99.0))  # the prior 0.01
        else:
            out[path] = 0.1 * rng.standard_normal(v.shape)
    return bridge.unflatten_tree({k: v.astype(np.float32) for k, v in out.items()})


def tiny_batch(seed: int = 0, b: int = 2, patch=(32, 32, 32)):
    """Images and instance segmentations of a few boxes, as NumPy."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((b, *patch), np.int32)
    table = np.full((b, 4), -1, np.int32)
    for i in range(b):
        for iid in range(1, 3 if i else 2):
            lo = rng.randint(2, 20, 3)
            ext = rng.randint(4, 11, 3)
            seg[i, lo[0]:lo[0] + ext[0], lo[1]:lo[1] + ext[1], lo[2]:lo[2] + ext[2]] = iid
            table[i, iid - 1] = 0
    images = rng.standard_normal((b, *patch, 1)).astype(np.float32)
    return images, seg, table


def jax_targets(seed: int = 0, b: int = 2):
    images, seg, table = tiny_batch(seed, b)
    out = j_prepare_targets(jnp.asarray(images), jnp.asarray(seg), jnp.asarray(table))
    return {k: np.array(v) for k, v in out.items()}


# ------------------------------------------------------------------ geometry
def test_encode_matches_jax():
    rng = np.random.RandomState(0)
    anchors = np.asarray(jax_cfg().anchors()[0][:400])
    gt = random_boxes(rng, 400)
    for weights in (None, (1.0, 1.0, 1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0, 10.0, 5.0)):
        want = JaxBoxCoder(weights=weights, dim=3).encode(jnp.asarray(gt), jnp.asarray(anchors))
        got = BoxCoder(weights=weights, dim=3).encode(t(gt), t(anchors))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GEOM_TOL, atol=GEOM_TOL)
    # decode inverts encode
    back = BoxCoder(dim=3).decode(BoxCoder(dim=3).encode(t(gt), t(anchors)), t(anchors))
    np.testing.assert_allclose(back.numpy(), gt, rtol=1e-5, atol=1e-4)


def test_pairwise_and_elementwise_geometry_match_jax():
    rng = np.random.RandomState(1)
    b1, b2 = random_boxes(rng, 50), random_boxes(rng, 70)
    b1[3] = b1[4]  # identical boxes
    for name in ("box_iou_union", "generalized_box_iou"):
        want = getattr(jops, name)(jnp.asarray(b1), jnp.asarray(b2), eps=1e-7)
        got = getattr(tops, name)(t(b1), t(b2), eps=1e-7)
        for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GEOM_TOL, atol=GEOM_TOL,
                                       err_msg=name)
    e1, e2 = b1, random_boxes(rng, 50)
    e2[:5] = e1[:5]
    for name in ("elementwise_box_iou", "elementwise_generalized_box_iou"):
        want = getattr(jops, name)(jnp.asarray(e1), jnp.asarray(e2))
        got = getattr(tops, name)(t(e1), t(e2))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GEOM_TOL, atol=GEOM_TOL,
                                   err_msg=name)
    for g, w in zip(tops.box_center_dist(t(b1), t(b2)),
                    jops.box_center_dist(jnp.asarray(b1), jnp.asarray(b2))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GEOM_TOL, atol=1e-5)
    centers = np.asarray(jops.box_center(jnp.asarray(e2))) + rng.uniform(-6, 6, (50, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tops.center_in_boxes(t(centers), t(e1)).numpy(),
        np.asarray(jops.center_in_boxes(jnp.asarray(centers), jnp.asarray(e1))))


def test_stable_topk_breaks_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0]])
    vals, idx = tops.stable_topk(x, 4)
    assert idx.tolist() == [[1, 2, 4, 5]]
    wv, wi = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert idx.numpy().tolist() == np.asarray(wi).tolist()


# -------------------------------------------------------------------- losses
def _loss_inputs(seed, n=600, c=3):
    rng = np.random.RandomState(seed)
    logits = (rng.standard_normal((n, c)) * 3).astype(np.float32)
    labels = rng.randint(0, c + 1, n).astype(np.int32)
    mask = rng.rand(n) < 0.4
    return rng, logits, labels, mask


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_bce_one_hot(smoothing):
    _, logits, labels, mask = _loss_inputs(0)
    want = JL.bce_one_hot(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), 3, smoothing)
    got = TL.bce_one_hot(t(logits), t(labels), t(mask), 3, smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("alpha", [-1.0, 0.25])
def test_focal_loss(alpha):
    _, logits, labels, mask = _loss_inputs(1)
    want = JL.focal_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), 3,
                         gamma=2.0, alpha=alpha)
    got = TL.focal_loss(t(logits), t(labels), t(mask), 3, gamma=2.0, alpha=alpha)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_box_regression_losses():
    rng = np.random.RandomState(2)
    pred, target = random_boxes(rng, 300), random_boxes(rng, 300)
    mask = rng.rand(300) < 0.3
    want = JL.giou_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    got = TL.giou_loss(t(pred), t(target), t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    d1, d2 = rng.standard_normal((2, 300, 6)).astype(np.float32) * 0.3
    want = JL.smooth_l1_loss(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mask))
    got = TL.smooth_l1_loss(t(d1), t(d2), t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    empty = np.zeros(300, bool)  # no positive: max(1, #pos) in the denominator
    assert float(TL.giou_loss(t(pred), t(target), t(empty))) == 0.0


def test_softmax_cross_entropies():
    rng, logits, labels, mask = _loss_inputs(3, c=4)
    labels = labels % 4
    w = np.asarray([0.2, 1.0, 2.0, 0.5], np.float32)
    for weight in (None, w):
        want = JL.softmax_ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  None if weight is None else jnp.asarray(weight))
        got = TL.softmax_ce_loss(t(logits), t(labels), None if weight is None else t(weight))
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)
        want = JL.softmax_ce_masked(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
                                    None if weight is None else jnp.asarray(weight))
        got = TL.softmax_ce_masked(t(logits), t(labels), t(mask),
                                   None if weight is None else tuple(weight.tolist()))
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    seg_logits = rng.standard_normal((2, 8, 8, 8, 3)).astype(np.float32)
    seg = rng.randint(0, 3, (2, 8, 8, 8)).astype(np.int32)
    want = JL.topk_ce_loss(jnp.asarray(seg_logits), jnp.asarray(seg), 10.0)
    got = TL.topk_ce_loss(t(seg_logits), t(seg), 10.0)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("batch_dice,do_bg", [(True, False), (False, False), (True, True)])
def test_soft_dice(batch_dice, do_bg):
    rng = np.random.RandomState(4)
    logits = rng.standard_normal((2, 6, 7, 8, 3)).astype(np.float32)
    seg = rng.randint(0, 3, (2, 6, 7, 8)).astype(np.int32)
    want = JL.soft_dice_loss(jnp.asarray(logits), jnp.asarray(seg), batch_dice, do_bg)
    got = TL.soft_dice_loss(t(logits), t(seg), batch_dice, do_bg)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_deep_supervision_seg_loss():
    rng = np.random.RandomState(5)
    seg = rng.randint(0, 2, (2, 16, 16, 8)).astype(np.int32)
    down = JL.maxpool_downsample_target(jnp.asarray(seg), (2, 2, 2))
    np.testing.assert_array_equal(TL.maxpool_downsample_target(t(seg), (2, 2, 2)).numpy(),
                                  np.asarray(down))
    logits = [rng.standard_normal((2, 16 // s, 16 // s, 8 // s, 2)).astype(np.float32)
              for s in (1, 2, 4)]
    strides = [(1, 1, 1), (2, 2, 2), (4, 4, 4)]
    want = JL.deep_supervision_seg_loss([jnp.asarray(v) for v in logits], jnp.asarray(seg), strides)
    got = TL.deep_supervision_seg_loss([t(v) for v in logits], t(seg), strides)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)


# ------------------------------------------------------------------ matching
def _anchors():
    cfg = jax_cfg()
    anchors, per_level = cfg.anchors()
    return np.asarray(anchors), per_level, cfg.anchors_per_loc()


def _gt(seed, b=3, g=4):
    rng = np.random.RandomState(seed)
    boxes = np.stack([random_boxes(rng, g, size=(3.0, 14.0)) for _ in range(b)])
    mask = rng.rand(b, g) < 0.8
    mask[:, 0] = True
    classes = rng.randint(0, 3, (b, g)).astype(np.int32)
    return boxes, mask, classes


@pytest.mark.parametrize("matcher", ["atss", "atss_center", "iou"])
def test_matchers_match_jax(matcher):
    anchors, per_level, per_loc = _anchors()
    boxes, mask, classes = _gt(6)
    if matcher == "iou":
        jm, tm = JaxIoU(0.3, 0.5), IoUMatcher(0.3, 0.5)
    else:
        center = matcher == "atss_center"
        jm = JaxATSS(center_in_gt=center, approx_topk=False)
        tm = ATSSMatcher(center_in_gt=center)
    got = tm(t(boxes), t(mask), t(anchors), per_level, per_loc)
    for i in range(boxes.shape[0]):
        want = jm(jnp.asarray(boxes[i]), jnp.asarray(mask[i]), jnp.asarray(anchors), per_level,
                  per_loc)
        assert (np.asarray(want.matched_idx) >= 0).any()
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want.matched_idx))
        wl, wb = j_gather_matched(want, jnp.asarray(boxes[i]), jnp.asarray(classes[i]))
        tl_, tb = gather_matched(got[i], t(boxes[i]), t(classes[i]))
        np.testing.assert_array_equal(tl_.numpy(), np.asarray(wl))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(wb))


def test_atss_ties_on_a_symmetric_grid_point():
    """A GT centred on a grid point of the stride-4 level: the 8 anchors of
    a position share a centre and the neighbouring positions are equally
    far, so the distance top-k has ties at its boundary. Exact selection with
    the lower index first gives the JAX exact matcher's matches; an order
    that breaks the ties otherwise picks other candidates."""
    anchors, per_level, per_loc = _anchors()
    gt = np.asarray([[[10.0, 10.0, 18.0, 18.0, 10.0, 18.0]]], np.float32)  # centre 14: a grid point
    mask = np.ones((1, 1), bool)
    want = JaxATSS(approx_topk=False)(jnp.asarray(gt[0]), jnp.asarray(mask[0]), jnp.asarray(anchors),
                                      per_level, per_loc).matched_idx
    got = ATSSMatcher()(t(gt), t(mask), t(anchors), per_level, per_loc)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the ties are real: the candidate boundary falls inside a group of
    # equal distances on the first level
    dist = np.asarray(jops.box_center_dist(jnp.asarray(gt[0]), jnp.asarray(anchors))[0])[0]
    level = np.sort(dist[:per_level[0]])
    k = 4 * per_loc
    assert level[k - 1] == level[k]


def test_atss_other_tie_order_gives_other_matches(monkeypatch):
    """Pins the hazard: breaking the distance ties toward the higher index
    selects other candidates and so other positives."""
    from nndetection_tpu_torch.core.boxes import matcher as tmatcher

    anchors, per_level, per_loc = _anchors()
    gt = t(np.asarray([[[10.0, 10.0, 18.0, 18.0, 10.0, 18.0]]], np.float32))
    mask = torch.ones(1, 1, dtype=torch.bool)
    exact = ATSSMatcher()(gt, mask, t(anchors), per_level, per_loc)

    def higher_index_first(values, k):
        vals, idx = tops.stable_topk(values.flip(-1), k)
        return vals, values.shape[-1] - 1 - idx

    monkeypatch.setattr(tmatcher, "stable_topk", higher_index_first)
    other = ATSSMatcher()(gt, mask, t(anchors), per_level, per_loc)
    assert not torch.equal(exact, other)


# ------------------------------------------------------------------ samplers
def _sampler_inputs(seed, b=3, n=3000):
    rng = np.random.RandomState(seed)
    labels = rng.choice([-1, 0, 1, 2], size=(b, n), p=[0.05, 0.9, 0.03, 0.02]).astype(np.int32)
    labels[-1, labels[-1] >= 1] = 0  # an image without positives
    probs = rng.rand(b, n).astype(np.float32)
    probs[0, :50] = 0.5  # ties in the score ranking
    return labels, probs


@pytest.mark.parametrize("name", ["HardNegativeSamplerBatched", "BalancedHardNegativeSampler",
                                  "HardNegativeSamplerFgAll"])
def test_samplers_with_injected_draws(monkeypatch, name):
    labels, probs = _sampler_inputs(7)
    b, n = labels.shape
    kw = {"max_anchors": 1024} if name == "HardNegativeSamplerFgAll" else {}
    js, ts = getattr(jsampler, name)(**kw), getattr(tsampler, name)(**kw)
    keys = jax.random.split(jax.random.PRNGKey(3), b)
    want = [js(keys[i], jnp.asarray(labels[i]), jnp.asarray(probs[i])) for i in range(b)]
    if name == "HardNegativeSamplerFgAll":
        cap = min(js.pool_cap, n)
        draws = [np.stack([np.asarray(jax.random.uniform(k, (cap,))) for k in keys])]
    else:
        draws = jax_draws(jax.random.PRNGKey(3), b, n, js.pool_cap)
    inject_draws(monkeypatch, draws)
    pos, neg = ts(torch.Generator(), t(labels), t(probs))
    for i in range(b):
        np.testing.assert_array_equal(pos[i].numpy(), np.asarray(want[i][0]))
        np.testing.assert_array_equal(neg[i].numpy(), np.asarray(want[i][1]))
    assert neg.any()


def test_sampler_draws_from_the_generator():
    labels, probs = _sampler_inputs(8)
    s = tsampler.HardNegativeSamplerBatched()
    a = s(torch.Generator().manual_seed(1), t(labels), t(probs))
    b = s(torch.Generator().manual_seed(1), t(labels), t(probs))
    c = s(torch.Generator().manual_seed(2), t(labels), t(probs))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert int(a[0].sum(1).max()) <= s.pos_cap and int(a[1].sum(1).max()) <= s.neg_cap


# ---------------------------------------------------------------- GT prep
def test_prepare_targets_matches_jax():
    images, seg, table = tiny_batch(3, b=3)
    seg[2, 0:3, 0:1, 5:9] = 3  # a sliver: dropped by the min-size filter
    table[2, 2] = 1
    seg[1, 30:, 30:, 30:] = -1  # outside the mask
    seg[0, 0:2, 0:2, 0:2] = 7  # an id beyond the table
    want = jax.device_get(j_prepare_targets(jnp.asarray(images), jnp.asarray(seg), jnp.asarray(table),
                                            min_box_size=2.0))
    got = prepare_targets(t(images), t(seg), t(table), min_box_size=2.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert want["gt_mask"].sum() >= 3 and not want["gt_mask"][2, 2]


# --------------------------------------------------------- train_step_loss
HEAD_CASES = [
    dict(),
    dict(matcher_type="iou"),
    dict(cls_loss_type="focal", reg_loss_type="l1"),
    dict(cls_loss_type="ce", class_weights=(0.5, 2.0)),
    dict(head_type="hnm_reg_all", matcher_center_in_gt=True),
    dict(head_type="no_sampler"),
    dict(head_type="no_sampler", cls_loss_type="focal", focal_alpha=0.25),
    dict(seg_loss_type="dice_topk", segmenter_alpha=0.3, batch_dice=False),
]


def _port_losses(monkeypatch, cfg_overrides, preds, targets, key):
    cfg = jax_cfg(exact_topk=True, **cfg_overrides)
    anchors, per_level = cfg.anchors()
    b, a = preds["box_logits"].shape[:2]
    want = jax.device_get(j_train_step_loss(
        cfg, {k: jnp.asarray(v) for k, v in preds.items()}, jnp.asarray(anchors), per_level,
        {k: jnp.asarray(v) for k, v in targets.items()}, key))
    if cfg.head_type != "no_sampler":
        inject_draws(monkeypatch, jax_draws(key, b, a, pool_cap(cfg)))
    got = train_step_loss(torch_cfg(**cfg_overrides), {k: t(v) for k, v in preds.items()},
                          t(anchors), per_level, {k: t(v) for k, v in targets.items()},
                          torch.Generator())
    return got, want


@pytest.mark.parametrize("overrides", HEAD_CASES)
def test_train_step_loss_branches_match_jax(monkeypatch, overrides):
    targets = jax_targets(0)
    cfg = jax_cfg(**overrides)
    a = len(cfg.anchors()[0])
    rng = np.random.RandomState(1)
    preds = {
        "box_logits": (rng.standard_normal((2, a, cfg.classifier_out_classes)) * 3).astype(np.float32),
        "box_deltas": (rng.standard_normal((2, a, 6)) * 0.2).astype(np.float32),
        "seg_logits": rng.standard_normal((2, 32, 32, 32, 2)).astype(np.float32),
    }
    got, want = _port_losses(monkeypatch, overrides, preds, targets, jax.random.PRNGKey(5))
    assert want["num_pos"] > 0
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("head", ["no_sampler", "hnm"])
def test_train_step_loss_on_the_tiny_model(monkeypatch, head):
    """The tiny float32 model with the same flax parameters on both sides
    (through ``bridge.state_dict_from_flax``), the JAX draws injected for
    the hard-negative head."""
    from nndetection_tpu.models import RetinaUNet as JaxRetinaUNet

    monkeypatch.delenv("NNDET_IN_STATS", raising=False)
    params = numpy_params()
    targets = jax_targets(1)
    cfg = jax_cfg(head_type=head)
    preds = jax.device_get(jax.jit(JaxRetinaUNet(cfg).apply)(params, targets["images"]))
    model = RetinaUNet(torch_cfg(head_type=head))
    model.load_state_dict(bridge.state_dict_from_flax(params, model))
    with torch.no_grad():
        tpreds = model(t(targets["images"]))
    for k in preds:
        np.testing.assert_allclose(tpreds[k].numpy(), preds[k], rtol=1e-4, atol=1e-4, err_msg=k)
    got, want = _port_losses(monkeypatch, {"head_type": head},
                             {k: v.numpy() for k, v in tpreds.items()}, targets,
                             jax.random.PRNGKey(0))
    assert want["num_pos"] > 0
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=k)


def test_deep_supervision_raises(monkeypatch):
    """A deep-supervision config raises nothing when only ``seg_logits`` is
    given: its segmentation loss is ``deep_supervision_seg_loss`` over that
    one level, as in the JAX package (the model's own levels:
    ``tests/test_torch_deep_supervision.py``)."""
    targets = jax_targets(0)
    a = len(jax_cfg().anchors()[0])
    rng = np.random.RandomState(3)
    preds = {
        "box_logits": (rng.standard_normal((2, a, 1)) * 3).astype(np.float32),
        "box_deltas": (rng.standard_normal((2, a, 6)) * 0.2).astype(np.float32),
        "seg_logits": rng.standard_normal((2, 32, 32, 32, 2)).astype(np.float32),
    }
    got, want = _port_losses(monkeypatch, {"segmenter_deep_supervision": True}, preds, targets,
                             jax.random.PRNGKey(6))
    assert float(got["seg_dice"]) == 0.0 and float(want["seg_ce"]) > 0
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=k)


def test_jax_config_fields_are_carried():
    assert {f.name for f in dataclasses.fields(torch_cfg())} == {
        f.name for f in dataclasses.fields(jax_cfg())}
