"""Direct photometric pose refinement (port of ``packnet_sfm_tpu/egomotion/
alignment.py``).

Gauss-Newton on the 6-DoF twist that minimizes the dense photometric
residual of the view-synthesis warp, with the target frame's predicted
depth. J has six columns, each the forward-mode derivative of the residual
along one twist coordinate, taken in two steps by the chain rule: the
sample coordinates' derivatives along the six coordinates at once
(``torch.func.jacfwd`` of the projection, through ``se3_exp`` at 0), then
one forward-mode pass of the warp for each (a dual number of
``torch.autograd.forward_ad``), which on the card is the ``warp_jvp``
kernel (``ops/warp.py``). The valid mask is piecewise constant and has no
tangent. JAX takes the same derivative in one ``jax.jvp`` of the whole
residual a column; eager forward mode pays a host-side price for every op
that mixes a dual tensor with a constant, which the split keeps to the
projection's few ops, once an iteration. The JAX package's ``lax.scan``
over the iterations is a Python loop here; the line search picks its trial
on the device (``torch.where``), as JAX does, so the loop does not wait on
the host.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.autograd.forward_ad as fwAD

from packnet_sfm_tpu_torch.geometry.camera import Camera, project, reconstruct, view_synthesis
from packnet_sfm_tpu_torch.geometry.se3 import se3_exp
from packnet_sfm_tpu_torch.losses.photometric import inv2depth
from packnet_sfm_tpu_torch.ops.warp import grid_sample


def _photometric_residual(xi, T0, target, ref, depth, K):
    """Per-pixel residual of warping ref into target with pose exp(xi)·T0,
    and the mask of pixels whose warp is not all zero (piecewise constant:
    it carries no tangent)."""
    T = se3_exp(xi[None])[0] @ T0
    cam = Camera(K=K)
    ref_cam = Camera(K=K, Tcw=T[None])
    warped = view_synthesis(ref, depth, ref_cam, cam, padding_mode="zeros")
    valid = (torch.sum(torch.abs(warped), dim=-1, keepdim=True) > 0).to(target.dtype)
    return ((warped - target) * valid).reshape(-1), valid


def _jacobian(T0, ref, world, K, valid):
    """d residual / d xi at xi = 0, [N, 6]: the coordinates' forward
    Jacobian, then the warp's forward mode along each of its columns."""
    def coords_of(xi):
        T = se3_exp(xi[None])[0] @ T0
        return project(Camera(K=K, Tcw=T[None]), world)

    xi0 = torch.zeros((6,), dtype=valid.dtype, device=valid.device)
    coords = coords_of(xi0)
    d_coords = torch.func.jacfwd(coords_of)(xi0)                    # [1, H, W, 2, 6]
    cols = []
    for i in range(6):
        with fwAD.dual_level():
            warped = grid_sample(ref, fwAD.make_dual(coords, d_coords[..., i].contiguous()),
                                 padding_mode="zeros")
            cols.append((fwAD.unpack_dual(warped).tangent * valid).reshape(-1))
    return torch.stack(cols, dim=-1)


def refine_pose_photometric(
    target: torch.Tensor,
    ref: torch.Tensor,
    inv_depth: torch.Tensor,
    K: torch.Tensor,
    T_init: torch.Tensor,
    num_iterations: int = 10,
    levels: int = 1,
    damping: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine the target->ref transform by direct alignment.

    target/ref: [1, H, W, 3]; inv_depth: [1, H, W, 1]; K: [1, 3, 3];
    T_init: [4, 4]. Returns (T_refined [4, 4], final mean |residual|).
    ``levels`` is accepted and unused, as in the JAX package.
    """
    depth = inv2depth(inv_depth)
    world = reconstruct(Camera(K=K), depth)
    dtype = target.dtype
    xi0 = torch.zeros((6,), dtype=dtype, device=target.device)
    eye6 = torch.eye(6, dtype=dtype, device=target.device)
    T = T_init

    for _ in range(num_iterations):
        def r_of(xi, T=T):
            return _photometric_residual(xi, T, target, ref, depth, K)[0]

        r0, valid = _photometric_residual(xi0, T, target, ref, depth, K)
        J = _jacobian(T, ref, world, K, valid)                        # [N, 6]
        H = J.T @ J + damping * eye6
        g = J.T @ r0
        dxi = -torch.linalg.solve(H, g)
        # halving line search (3 trials) to keep Gauss-Newton robust; the
        # cost at xi = 0 is the sum of r0 squared
        best_T, best_c = T, torch.sum(r0 * r0)
        for scale in (1.0, 0.5, 0.25):
            T_try = se3_exp((scale * dxi)[None])[0] @ T
            r = r_of(scale * dxi)
            c_try = torch.sum(r * r)
            take = c_try < best_c
            best_T = torch.where(take, T_try, best_T)
            best_c = torch.where(take, c_try, best_c)
        T = best_T

    res, valid = _photometric_residual(xi0, T, target, ref, depth, K)
    mean_abs = torch.sum(torch.abs(res)) / torch.clamp(torch.sum(valid) * 3, min=1.0)
    return T, mean_abs
