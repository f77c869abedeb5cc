"""Augmentation presets (counterpart of :mod:`nndetection_tpu.data.aug_presets`):
``no_aug``, ``default``, ``base_more`` (the published default), ``more`` and
``insane``, registered by name in ``AUGMENTATION_REGISTRY``.

Each preset takes the plan's switches: ``dummy_2d`` (anisotropic patches,
``max(patch) / min(patch) > 3``) applies the 2D overwrites (in-plane
rotation up to 180 deg, elastic alpha up to 200), ``mask_norm_zero`` zeroes
the data outside the normalization mask.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Sequence

from nndetection_tpu_torch.data.augment import AugmentConfig
from nndetection_tpu_torch.utils.registry import AUGMENTATION_REGISTRY


def _base(patch_size: Sequence[int]) -> AugmentConfig:
    return AugmentConfig(patch_size=tuple(patch_size))


def _apply_plan_switches(cfg: AugmentConfig, dummy_2d: bool, mask_norm_zero: bool):
    """The 2D overwrites and the mask zeroing."""
    if dummy_2d:
        cfg = replace(
            cfg,
            dummy_2d=True,
            rotation_deg=180.0,
            elastic_alpha=(0.0, 200.0),
            elastic_sigma=(9.0, 13.0),
        )
    if mask_norm_zero:
        cfg = replace(cfg, mask_norm_zero=True)
    return cfg


@AUGMENTATION_REGISTRY.register(name="no_aug")
def no_aug(patch_size: Sequence[int], dummy_2d: bool = False,
           mask_norm_zero: bool = False) -> AugmentConfig:
    return replace(
        _base(patch_size),
        p_rotation=0.0, p_scale=0.0, p_noise=0.0, p_blur=0.0,
        p_brightness=0.0, p_contrast=0.0, p_lowres=0.0, p_gamma=0.0,
        mirror_axes=(),
    )


@AUGMENTATION_REGISTRY.register(name="default")
def default(patch_size: Sequence[int], dummy_2d: bool = False,
            mask_norm_zero: bool = False) -> AugmentConfig:
    """Elastic on (p 0.2, alpha 0-900, sigma 9-13), rotation +-15 deg,
    scale 0.85-1.25, gamma 0.3, mirror; no noise, blur, brightness,
    contrast or low resolution."""
    cfg = replace(
        _base(patch_size),
        p_elastic=0.2,
        elastic_alpha=(0.0, 900.0),
        elastic_sigma=(9.0, 13.0),
        rotation_deg=15.0,
        scale_range=(0.85, 1.25),
        p_noise=0.0, p_blur=0.0, p_brightness=0.0, p_contrast=0.0,
        p_lowres=0.0,
    )
    return _apply_plan_switches(cfg, dummy_2d, mask_norm_zero)


@AUGMENTATION_REGISTRY.register(name="base_more")
def base_more(patch_size: Sequence[int], dummy_2d: bool = False,
              mask_norm_zero: bool = False) -> AugmentConfig:
    """The published default; elastic off."""
    return _apply_plan_switches(_base(patch_size), dummy_2d, mask_norm_zero)


@AUGMENTATION_REGISTRY.register(name="more")
def more(patch_size: Sequence[int], dummy_2d: bool = False,
         mask_norm_zero: bool = False) -> AugmentConfig:
    cfg = replace(
        _base(patch_size),
        p_rotation=0.3, p_scale=0.3, scale_range=(0.65, 1.6),
        p_noise=0.15, p_blur=0.25, p_brightness=0.25, p_contrast=0.25,
        p_lowres=0.3, p_gamma=0.3,
    )
    return _apply_plan_switches(cfg, dummy_2d, mask_norm_zero)


@AUGMENTATION_REGISTRY.register(name="insane")
def insane(patch_size: Sequence[int], dummy_2d: bool = False,
           mask_norm_zero: bool = False) -> AugmentConfig:
    """Elastic on (alpha 0-1300, sigma 9-15)."""
    cfg = replace(
        _base(patch_size),
        p_elastic=0.2,
        elastic_alpha=(0.0, 1300.0),
        elastic_sigma=(9.0, 15.0),
        p_rotation=0.5, rotation_deg=40.0, p_scale=0.5, scale_range=(0.6, 1.8),
        p_noise=0.25, p_blur=0.35, p_brightness=0.35, p_contrast=0.35,
        p_lowres=0.4, p_gamma=0.4, p_gamma_invert=0.2,
    )
    return _apply_plan_switches(cfg, dummy_2d, mask_norm_zero)


def get_augmentation(
    name: str,
    patch_size: Sequence[int],
    dummy_2d: bool = False,
    mask_norm_zero: bool = False,
) -> AugmentConfig:
    return AUGMENTATION_REGISTRY[name](patch_size, dummy_2d=dummy_2d, mask_norm_zero=mask_norm_zero)
