"""The port's augmentation against the JAX package's gather branch, on
seeded NumPy inputs at patch <= 16^3: the generator patch sizes, the linear
and nearest gathers against ``map_coordinates`` (exact halves and
out-of-range coordinates included), the blur, the elastic field and the
affine coordinates part by part; then whole batches of every preset with
JAX's draws injected into ``apply_augment``; last the port's own draws on
their distribution.

XLA's float32 ``cos``/``sin`` and PyTorch's differ in the last bit, and
XLA's convolution and resize sum in another order, so the rotation matrix
and the elastic field are held to JAX's at float32 tolerance in their own
tests, and the whole-batch tests give the port JAX's matrix and field as
well as its draws: then every source coordinate is JAX's to the bit, and
the segmentation can be held exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.ndimage import map_coordinates

from nndetection_tpu.data import aug_presets as JP
from nndetection_tpu.data import augment as JA
from nndetection_tpu_torch.data import aug_presets as TP
from nndetection_tpu_torch.data import augment as TA

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ULP = 2.0 ** -7  # relative spacing of bfloat16
PRESETS = ("no_aug", "default", "base_more", "more", "insane")
PATCH = (12, 16, 16)


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ JAX's draws
def jax_params(key, cfg, batch: int, channels: int) -> TA.AugmentParams:
    """JAX ``augment_batch``'s draws for ``key`` as the port's
    :class:`AugmentParams`: each draw with the key and the call that
    ``augment_sample`` (key split into 17) and ``_sample_affine_params`` /
    ``_elastic_field`` make it with."""
    out_shape = tuple(cfg.patch_size)
    dim = len(out_shape)
    u = jax.random.uniform

    def one(key):
        ks = jax.random.split(key, 17)
        k_rot, k_rot_p, k_scale, k_scale_p = jax.random.split(ks[0], 4)
        max_rad = jnp.deg2rad(cfg.rotation_deg)
        k_n, k_a, k_s, k_p = jax.random.split(ks[16], 4)
        return dict(
            angles=u(k_rot, (3,), minval=-max_rad, maxval=max_rad),
            do_rotation=u(k_rot_p) < cfg.p_rotation,
            scale=u(k_scale, (), minval=cfg.scale_range[0], maxval=cfg.scale_range[1]),
            do_scale=u(k_scale_p) < cfg.p_scale,
            flips=u(ks[1], (dim,)) < 0.5,
            noise_var=u(ks[2], (), minval=cfg.noise_var[0], maxval=cfg.noise_var[1]),
            noise=jax.random.normal(ks[3], (*out_shape, channels)),
            do_noise=u(ks[4]) < cfg.p_noise,
            blur_sigma=u(ks[5], (), minval=cfg.blur_sigma[0], maxval=cfg.blur_sigma[1]),
            do_blur=u(ks[6]) < cfg.p_blur,
            brightness=u(ks[7], (), minval=cfg.brightness_range[0],
                         maxval=cfg.brightness_range[1]),
            do_brightness=u(ks[12]) < cfg.p_brightness,
            contrast=u(ks[8], (), minval=cfg.contrast_range[0], maxval=cfg.contrast_range[1]),
            do_contrast=u(ks[13]) < cfg.p_contrast,
            zoom=u(ks[9], (), minval=cfg.lowres_zoom[0], maxval=cfg.lowres_zoom[1]),
            do_lowres=(u(ks[14]) < cfg.p_lowres) & (cfg.p_lowres > 0),
            gamma=u(ks[10], (), minval=cfg.gamma_range[0], maxval=cfg.gamma_range[1]),
            gamma_invert=u(ks[11], ()) < cfg.p_gamma_invert,
            do_gamma=u(ks[15]) < cfg.p_gamma,
            elastic_alpha=u(k_a, (), minval=cfg.elastic_alpha[0], maxval=cfg.elastic_alpha[1]),
            elastic_sigma=u(k_s, (), minval=cfg.elastic_sigma[0], maxval=cfg.elastic_sigma[1]),
            do_elastic=u(k_p) < cfg.p_elastic,
            elastic_noise=u(k_n, (dim, *TA.elastic_lattice_shape(out_shape)),
                            minval=-1.0, maxval=1.0),
        )

    rows = [one(k) for k in jax.random.split(key, batch)]
    params = {k: t(np.stack([np.asarray(r[k]) for r in rows])) for k in rows[0]}
    if cfg.p_elastic == 0:
        params["elastic_noise"] = None
    return TA.AugmentParams(**params)


def jax_rotation(angles: torch.Tensor) -> torch.Tensor:
    """JAX's ``_rotation_matrix_3d`` of each row of ``angles``, batched as
    ``augment_batch`` computes it."""
    return t(jax.vmap(JA._rotation_matrix_3d)(jnp.asarray(angles.numpy())))


def jax_field(key, cfg, batch):
    """JAX's ``_elastic_field`` of each sample of ``augment_batch`` for
    ``key`` (trigger and dummy-2D mask applied)."""
    keys = jax.vmap(lambda k: jax.random.split(k, 17)[16])(jax.random.split(key, batch))
    return jax.vmap(lambda k: JA._elastic_field(k, tuple(cfg.patch_size), cfg))(keys)


def jax_cfg(cfg: TA.AugmentConfig) -> JA.AugmentConfig:
    """The JAX config of a port config, on the gather branch."""
    return dataclasses.replace(JA.AugmentConfig(**dataclasses.asdict(cfg)),
                               use_mxu_resample=False)


def inputs(seed, batch, in_shape, channels, dtype=np.float32):
    rng = np.random.RandomState(seed)
    data = rng.standard_normal((batch, *in_shape, channels)).astype(np.float32)
    seg = rng.randint(0, 4, (batch, *in_shape)).astype(np.int32)
    # a band outside the normalization mask, for mask_norm_zero
    seg[:, : max(1, in_shape[0] // 6)] = -1
    if dtype != np.float32:
        data = np.asarray(jnp.asarray(data, dtype))
    return data, seg


# ------------------------------------------------------------ part by part
@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("patch,dummy_2d", [((16, 16, 16), False), ((4, 16, 16), True),
                                             ((16, 16), False), ((15, 16), False)])
def test_generator_patch_size(name, patch, dummy_2d):
    want = JA.generator_patch_size_for(JP.get_augmentation(name, patch, dummy_2d=dummy_2d))
    cfg = TP.get_augmentation(name, patch, dummy_2d=dummy_2d)
    assert TA.generator_patch_size_for(cfg) == want
    assert TA.get_generator_patch_size((96, 128, 128), 30.0, 0.7) == (211, 250, 250)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JP.get_augmentation(name, patch, dummy_2d=dummy_2d))


def probe_coords(rng, in_shape, n=400):
    """Coordinates with exact halves, integers, out-of-range values and
    random ones, ``[dim, n]`` float32."""
    dim = len(in_shape)
    special = np.array([-1.5, -1.0, -0.5, -0.49999997, 0.0, 0.5, 1.5, 2.5], np.float32)
    cols = []
    for d in range(dim):
        s = in_shape[d]
        pool = np.concatenate([special, s - 1.5 + special + 1.0, np.arange(s) + 0.5,
                               rng.uniform(-2, s + 1, n)]).astype(np.float32)
        cols.append(rng.choice(pool, n))
    return np.stack(cols)


@pytest.mark.parametrize("in_shape", [(7, 9, 6), (9, 11)])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_gathers_match_map_coordinates(in_shape, dtype):
    rng = np.random.RandomState(0)
    coords = probe_coords(rng, in_shape)
    data = rng.standard_normal(in_shape).astype(np.float32)
    data = np.asarray(jnp.asarray(data, dtype))
    seg = rng.randint(0, 5, in_shape).astype(np.int32)
    want_lin = np.asarray(map_coordinates(jnp.asarray(data), list(jnp.asarray(coords)), order=1,
                                          mode="constant"))
    want_near = np.asarray(map_coordinates(jnp.asarray(seg, jnp.float32), list(jnp.asarray(coords)),
                                           order=0, mode="constant", cval=-1.0)).astype(np.int32)
    tdata = t(data.astype(np.float32)).to(torch.bfloat16 if dtype != np.float32 else torch.float32)
    got_lin = TA._gather_linear(tdata[None, ..., None], t(coords)[None])[0, ..., 0]
    got_near = TA._gather_nearest(t(seg)[None], t(coords)[None])[0]
    np.testing.assert_array_equal(got_near.numpy(), want_near)
    np.testing.assert_allclose(got_lin.float().numpy(), want_lin.astype(np.float32), **F32_TOL)
    assert got_lin.dtype == tdata.dtype


def test_round_half_away():
    x = torch.tensor([-2.5, -1.5, -0.5, -0.49999997, 0.49999997, 0.5, 1.5, 2.5, 3.2, -3.7])
    want = np.asarray(jax.lax.round(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(TA._round_half_away(x).numpy(), want)


@pytest.mark.parametrize("ksize", [7, 9])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_gaussian_blur_1d(ksize, axis):
    rng = np.random.RandomState(ksize + axis)
    x = rng.standard_normal((2, 5, 9, 4)).astype(np.float32)
    sigma = np.array([0.0, 2.7], np.float32)  # the 1e-3 floor, then a wide kernel
    want = np.stack([np.asarray(JA._gaussian_blur_1d(jnp.asarray(x[i]), jnp.asarray(sigma[i]),
                                                     axis=axis, ksize=ksize)) for i in range(2)])
    got = TA._gaussian_blur_1d(t(x), t(sigma), axis=axis + 1, ksize=ksize)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("out_shape", [(12, 16, 16), (13, 7, 10), (16, 15)])
def test_elastic_field(out_shape):
    """The port's field against JAX's ``_elastic_field`` with the lattice
    noise, alpha and sigma injected (the trigger on)."""
    cfg = JA.AugmentConfig(patch_size=out_shape, p_elastic=1.0)
    dim = len(out_shape)
    key = jax.random.PRNGKey(3)
    k_n, k_a, k_s, _ = jax.random.split(key, 4)
    want = np.asarray(JA._elastic_field(key, out_shape, cfg))
    noise = jax.random.uniform(k_n, (dim, *TA.elastic_lattice_shape(out_shape)),
                               minval=-1.0, maxval=1.0)
    alpha = jax.random.uniform(k_a, (), minval=cfg.elastic_alpha[0], maxval=cfg.elastic_alpha[1])
    sigma = jax.random.uniform(k_s, (), minval=cfg.elastic_sigma[0], maxval=cfg.elastic_sigma[1])
    got = TA._elastic_field(t(noise)[None], t(alpha)[None], t(sigma)[None], out_shape)[0]
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("size_in,size_out", [(5, 17), (5, 20), (4, 13), (9, 33)])
def test_interpolate_matches_jax_resize(size_in, size_out):
    """``F.interpolate(align_corners=False)`` against ``jax.image.resize``
    "linear" when upsampling: half-pixel centres, the edges clamped."""
    x = np.random.RandomState(size_in).standard_normal((2, size_in, size_in + 1)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, size_out, size_out + 3), "linear"))
    got = torch.nn.functional.interpolate(t(x)[None], size=(size_out, size_out + 3),
                                          mode="bilinear", align_corners=False)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("patch,dummy_2d", [((12, 16, 16), False), ((4, 16, 16), True),
                                             ((15, 16), False)])
def test_affine_coords(patch, dummy_2d):
    """Rotation matrices within float32 rounding of JAX's; coordinates
    bit for bit given JAX's matrix (the dot's fused multiply-adds), and
    within 1e-5 voxel with the port's own."""
    cfg = dataclasses.replace(TP.get_augmentation("insane", patch, dummy_2d=dummy_2d),
                              p_rotation=0.7, p_scale=0.7)
    in_shape = TA.generator_patch_size_for(cfg)
    key = jax.random.PRNGKey(5)
    params = jax_params(key, jax_cfg(cfg), 6, 1)
    want = np.stack([np.asarray(JA._affine_coords(jax.random.split(k, 17)[0], in_shape, patch,
                                                  jax_cfg(cfg)))
                     for k in jax.random.split(key, 6)])
    angles = torch.where(params.do_rotation[:, None], params.angles, 0.0)
    np.testing.assert_allclose(TA._rotation_matrix_3d(angles).numpy(),
                               jax_rotation(angles).numpy(), rtol=0, atol=2e-7)
    own = TA._affine_coords(TA._affine_matrix(params, cfg, len(patch)), in_shape, patch)
    np.testing.assert_allclose(own.numpy(), want, rtol=0, atol=1e-5)
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(TA, "_rotation_matrix_3d", jax_rotation)
        got = TA._affine_coords(TA._affine_matrix(params, cfg, len(patch)), in_shape, patch)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- whole
def run_both(monkeypatch, cfg, seed, batch=2, channels=1, in_shape=None, dtype=np.float32):
    jcfg = jax_cfg(cfg)
    in_shape = in_shape or TA.generator_patch_size_for(cfg)
    data, seg = inputs(seed, batch, in_shape, channels, dtype)
    key = jax.random.PRNGKey(seed)
    want_x, want_s = JA.augment_batch(key, jnp.asarray(data), jnp.asarray(seg), jcfg)
    params = jax_params(key, jcfg, batch, channels)
    monkeypatch.setattr(TA, "_rotation_matrix_3d", jax_rotation)
    if cfg.p_elastic > 0:
        field = t(jax_field(key, jcfg, batch))
        monkeypatch.setattr(TA, "_elastic_field", lambda *a, **k: field)
    tdata = t(data.astype(np.float32)).to(torch.bfloat16 if dtype != np.float32 else torch.float32)
    got_x, got_s = TA.apply_augment(tdata, t(seg), params, cfg)
    return (got_x, got_s), (np.asarray(want_x), np.asarray(want_s)), params


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_batch_presets(monkeypatch, name, seed):
    cfg = TP.get_augmentation(name, PATCH)
    (gx, gs), (wx, ws), _ = run_both(monkeypatch, cfg, seed)
    assert gx.dtype == torch.float32 and gs.dtype == torch.int32
    assert tuple(gx.shape) == wx.shape and tuple(gs.shape) == ws.shape
    np.testing.assert_array_equal(gs.numpy(), ws)
    np.testing.assert_allclose(gx.numpy(), wx, **F32_TOL)


@pytest.mark.parametrize("case", ["dummy_2d", "mask_norm_zero", "2d", "odd_margin", "channels"])
def test_augment_batch_switches(monkeypatch, case):
    """The plan switches, a 2D patch, a generator patch one voxel larger on
    axis 0 (half-voxel sampling there) and two channels, each with every
    transform more likely to fire."""
    hot = dict(p_rotation=0.6, p_scale=0.6, p_noise=0.5, p_blur=0.5, p_brightness=0.5,
               p_contrast=0.5, p_lowres=0.5, p_gamma=0.5, p_gamma_invert=0.5)
    kw, patch, in_shape, channels = {}, PATCH, None, 1
    if case == "dummy_2d":
        patch, kw = (4, 16, 16), dict(dummy_2d=True)
    elif case == "mask_norm_zero":
        kw = dict(mask_norm_zero=True)
    elif case == "2d":
        patch = (15, 16)
    elif case == "odd_margin":
        in_shape = tuple(s + (i == 0) for i, s in enumerate(
            TA.generator_patch_size_for(TP.get_augmentation("more", patch))))
    else:
        channels = 2
    name = "insane" if case == "dummy_2d" else "more"
    cfg = dataclasses.replace(TP.get_augmentation(name, patch, **kw), **hot)
    for seed in range(3):
        (gx, gs), (wx, ws), params = run_both(monkeypatch, cfg, seed, batch=3, channels=channels,
                                              in_shape=in_shape)
        np.testing.assert_array_equal(gs.numpy(), ws)
        np.testing.assert_allclose(gx.numpy(), wx, **F32_TOL)
        if case == "mask_norm_zero":
            assert (gx.numpy()[gs.numpy() < 0] == 0).all()


@pytest.mark.parametrize("name", ["no_aug", "base_more", "more"])
def test_augment_batch_bf16(monkeypatch, name):
    """bf16 input: the gather rounds to bf16 as ``map_coordinates`` does;
    images within one bf16 ulp of each voxel's magnitude."""
    cfg = TP.get_augmentation(name, PATCH)
    for seed in range(3):
        (gx, gs), (wx, ws), _ = run_both(monkeypatch, cfg, seed, dtype=jnp.bfloat16)
        np.testing.assert_array_equal(gs.numpy(), ws)
        assert wx.dtype == np.float32
        np.testing.assert_allclose(gx.numpy(), wx, rtol=BF16_ULP, atol=1e-4)


def test_no_aug_is_a_crop_at_even_margins():
    """``no_aug`` at an even margin is the centre crop; at an odd margin it
    averages two voxels on that axis."""
    cfg = TP.get_augmentation("no_aug", (4, 6, 6))
    params = TA.sample_augment_params(cfg, 2, 1, torch.Generator().manual_seed(0), "cpu")
    data, seg = inputs(0, 2, (8, 10, 10), 1)
    x, s = TA.apply_augment(t(data), t(seg), params, cfg)
    cx, cs = TA.center_crop_batch(t(data), t(seg), cfg.patch_size)
    assert torch.equal(x, cx) and torch.equal(s, cs)
    data, seg = inputs(0, 2, (9, 10, 10), 1)
    x, s = TA.apply_augment(t(data), t(seg), params, cfg)
    avg = (t(data)[:, 2:6] + t(data)[:, 3:7]) / 2
    torch.testing.assert_close(x, avg[:, :, 2:8, 2:8], rtol=1e-6, atol=1e-6)
    # the segmentation rounds 2.5 up to 3
    assert torch.equal(s, t(seg)[:, 3:7, 2:8, 2:8])


def test_center_crop_matches_jax():
    data, seg = inputs(4, 2, (9, 12, 11), 1)
    want = JA.center_crop_batch(jnp.asarray(data), jnp.asarray(seg), (4, 6, 6))
    got = TA.center_crop_batch(t(data), t(seg), (4, 6, 6))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------------- draws
def test_sampler_rates_and_ranges():
    """Trigger rates within 5 binomial standard deviations of each
    probability, every draw inside its range, and one generator giving the
    same draws twice."""
    cfg = TP.get_augmentation("insane", (4, 6, 6))
    n = 4000
    p = TA.sample_augment_params(cfg, n, 2, torch.Generator().manual_seed(1), "cpu")
    again = TA.sample_augment_params(cfg, n, 2, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(p.noise, again.noise) and torch.equal(p.angles, again.angles)
    rates = dict(do_rotation=cfg.p_rotation, do_scale=cfg.p_scale, do_noise=cfg.p_noise,
                 do_blur=cfg.p_blur, do_brightness=cfg.p_brightness,
                 do_contrast=cfg.p_contrast, do_lowres=cfg.p_lowres, do_gamma=cfg.p_gamma,
                 gamma_invert=cfg.p_gamma_invert, do_elastic=cfg.p_elastic)
    for name, prob in rates.items():
        rate = float(getattr(p, name).float().mean())
        assert abs(rate - prob) < 5 * np.sqrt(prob * (1 - prob) / n), (name, rate, prob)
    flips = p.flips.float().mean(0)
    assert (abs(flips - 0.5) < 5 * np.sqrt(0.25 / n)).all()
    max_rad = np.deg2rad(cfg.rotation_deg)
    ranges = dict(angles=(-max_rad, max_rad), scale=cfg.scale_range,
                  noise_var=cfg.noise_var, blur_sigma=cfg.blur_sigma,
                  brightness=cfg.brightness_range, contrast=cfg.contrast_range,
                  zoom=cfg.lowres_zoom, gamma=cfg.gamma_range,
                  elastic_alpha=cfg.elastic_alpha, elastic_sigma=cfg.elastic_sigma,
                  elastic_noise=(-1.0, 1.0))
    for name, (lo, hi) in ranges.items():
        v = getattr(p, name)
        assert float(v.min()) >= lo - 1e-6 and float(v.max()) <= hi + 1e-6, name
        # the draws spread over the range
        assert float(v.min()) < lo + 0.05 * (hi - lo) and float(v.max()) > hi - 0.05 * (hi - lo)
    assert tuple(p.noise.shape) == (n, 4, 6, 6, 2)
    assert abs(float(p.noise.mean())) < 0.01 and abs(float(p.noise.std()) - 1) < 0.01
    assert tuple(p.elastic_noise.shape) == (n, 3, 2, 3, 3)
    assert TA.sample_augment_params(TP.get_augmentation("base_more", (4, 6, 6)), 2, 1,
                                    torch.Generator(), "cpu").elastic_noise is None


def test_augment_batch_runs_its_draws():
    """``augment_batch`` is ``apply_augment`` of the draws of the same
    generator state."""
    cfg = TP.get_augmentation("more", (4, 6, 6))
    data, seg = inputs(2, 3, TA.generator_patch_size_for(cfg), 1)
    got = TA.augment_batch(torch.Generator().manual_seed(7), t(data), t(seg), cfg)
    params = TA.sample_augment_params(cfg, 3, 1, torch.Generator().manual_seed(7), "cpu")
    want = TA.apply_augment(t(data), t(seg), params, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
