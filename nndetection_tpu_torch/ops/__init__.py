"""Hand-written Hopper kernels, each beside a plain PyTorch version of the
same function.

A wrapper calls the plain version for a tensor on the CPU. For a CUDA tensor
it launches its kernel or raises; there is no fallback on the card.
:data:`LAUNCHES` counts kernel launches per wrapper name, so that a run can
show that its main path went through the kernels.

The box kernels take 3D boxes ``(x1, y1, x2, y2, z1, z2)``; a 2D box enters
them through :func:`lift_2d` as a box of unit depth.
"""
from collections import Counter

import torch

LAUNCHES: Counter = Counter()


def lift_2d(boxes: torch.Tensor) -> torch.Tensor:
    """2D boxes ``[..., 4]`` as 3D boxes ``[..., 6]`` of unit depth,
    ``(x1, y1, x2, y2, 0, 1)``; 3D boxes unchanged. With ``iz = dz = 1`` the
    kernels' ``(ix * iy) * iz`` and ``(dx * dy) * dz`` are exact, so a lifted
    pair has the 2D IoU ``ix * iy / (a1 + a2 - ix * iy)`` to the bit (where
    the union is above the kernels' floor of 1e-12)."""
    if boxes.shape[-1] == 6:
        return boxes
    if boxes.shape[-1] != 4:
        raise ValueError(f"boxes need 4 or 6 coordinates, got {boxes.shape[-1]}")
    z = torch.zeros((*boxes.shape[:-1], 2), dtype=boxes.dtype, device=boxes.device)
    z[..., 1] = 1.0
    return torch.cat([boxes, z], dim=-1)
