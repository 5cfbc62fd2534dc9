"""Windowed pose-graph bundle adjustment with Schur-complement reduction
(port of ``packnet_sfm_tpu/egomotion/posegraph.py``).

N keyframe poses T_i (world<-frame) and a log-scale s_i each are fitted to
E relative-pose edges Z_ij: the residual of an edge is
r_ij = log(Z_ij(s_i)^-1 · T_i^-1 · T_j) in se(3), where Z_ij(s_i) scales
the measured translation by exp(s_i). Gauss-Newton with a fixed number of
iterations: the per-edge Jacobians by forward-mode AD (``torch.func.
jacfwd``), dense [6N] and [N] normal equations, the scale block eliminated
by its Schur complement, the gauge fixed by strong priors on pose 0 and
scale 0.

Where the JAX package vmaps one edge's residual over the edges, the port
computes every edge's residual at once (a function of all the twists and
scales, [E, 6]); its forward Jacobian holds the same per-edge blocks, since
an edge's residual depends only on its own two poses and scale.
``optimize_pose_graph_sharded`` splits the edges over the ranks of the
process group and sums the normal equations across them each iteration
(``parallel/mesh.all_reduce_sum``), as the JAX package's ``shard_map``
sums them with a ``psum``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from packnet_sfm_tpu_torch.geometry.pose import invert_pose
from packnet_sfm_tpu_torch.geometry.se3 import se3_exp, se3_log


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    num_iterations: int = 12
    damping: float = 1e-6
    pose_prior: float = 1e6      # gauge fixing on pose 0
    scale_prior: float = 1e6     # gauge fixing on scale 0
    rot_weight: float = 100.0    # rotation residual weight vs translation
    optimize_scales: bool = True


def _edge_residual(poses_xi, scales, T_lin, i, j, Z, rot_weight):
    """Residuals [E, 6] of the edges (i, j, Z: [E], [E], [E, 4, 4]) at twist
    updates ``poses_xi`` [N, 6] around the linearization ``T_lin``
    [N, 4, 4], with log-scales ``scales`` [N]."""
    Ti = se3_exp(poses_xi[i]) @ T_lin[i]
    Tj = se3_exp(poses_xi[j]) @ T_lin[j]
    s = torch.exp(scales[i])[:, None, None]
    Zs = torch.cat([torch.cat([Z[:, :3, :3], Z[:, :3, 3:] * s], -1), Z[:, 3:]], -2)
    rel = invert_pose(Zs) @ (invert_pose(Ti) @ Tj)
    r = se3_log(rel)
    weight = torch.tensor([1.0, 1.0, 1.0, rot_weight, rot_weight, rot_weight],
                          dtype=poses_xi.dtype, device=poses_xi.device)
    return r * weight


def _edge_system(T_lin, scales, edges, rot_weight):
    """Jacobian blocks and residuals of every edge, weighted:
    (J_p [E, 6, N*6], J_s [E, 6, N], r [E, 6]), dense over the window."""
    n = T_lin.shape[0]
    i, j, Z, w = edges["i"], edges["j"], edges["Z"], edges["w"]

    def r_of(xi_flat, s):
        return _edge_residual(xi_flat.reshape(n, 6), s, T_lin, i, j, Z, rot_weight)

    xi0 = torch.zeros((n * 6,), dtype=T_lin.dtype, device=T_lin.device)
    r0 = r_of(xi0, scales)
    Jp = torch.func.jacfwd(r_of, argnums=0)(xi0, scales)     # [E, 6, N*6]
    Js = torch.func.jacfwd(r_of, argnums=1)(xi0, scales)     # [E, 6, N]
    return Jp * w[:, None, None], Js * w[:, None, None], r0 * w[:, None]


def _build_normal_equations(T_lin, scales, edges, rot_weight):
    """The edges' systems summed: (H_pp, H_ps, H_ss, b_p, b_s)."""
    Jp, Js, r = _edge_system(T_lin, scales, edges, rot_weight)
    return (torch.einsum("eka,ekb->ab", Jp, Jp), torch.einsum("eka,ekb->ab", Jp, Js),
            torch.einsum("eka,ekb->ab", Js, Js), torch.einsum("eka,ek->a", Jp, r),
            torch.einsum("eka,ek->a", Js, r))


def _solve_schur(H_pp, H_ps, H_ss, b_p, b_s, cfg: PoseGraphConfig, n):
    """Gauge priors, then Schur elimination of the scale block."""
    dtype, device = H_pp.dtype, H_pp.device
    prior_p = torch.zeros((n * 6,), dtype=dtype, device=device)
    prior_p[:6] = cfg.pose_prior
    H_pp = H_pp + torch.diag(prior_p) + cfg.damping * torch.eye(n * 6, dtype=dtype,
                                                                device=device)
    prior_s = torch.zeros((n,), dtype=dtype, device=device)
    prior_s[0] = cfg.scale_prior
    H_ss = H_ss + torch.diag(prior_s) + cfg.damping * torch.eye(n, dtype=dtype, device=device)

    if cfg.optimize_scales:
        H_ss_inv = torch.linalg.inv(H_ss)
        H_red = H_pp - H_ps @ H_ss_inv @ H_ps.T
        b_red = b_p - H_ps @ (H_ss_inv @ b_s)
        dxi = -torch.linalg.solve(H_red, b_red)
        ds = -H_ss_inv @ (b_s + H_ps.T @ dxi)
    else:
        dxi = -torch.linalg.solve(H_pp, b_p)
        ds = torch.zeros((n,), dtype=dtype, device=device)
    return dxi.reshape(n, 6), ds


def _gauss_newton(T_init, edges, cfg: PoseGraphConfig, reduce):
    """The iterations and the final cost, with ``reduce`` applied to each
    sum over the edges (the identity, or a sum across ranks)."""
    n = T_init.shape[0]
    T, scales = T_init, torch.zeros((n,), dtype=T_init.dtype, device=T_init.device)
    for _ in range(cfg.num_iterations):
        sums = [reduce(s) for s in _build_normal_equations(T, scales, edges, cfg.rot_weight)]
        dxi, ds = _solve_schur(*sums, cfg, n)
        T, scales = se3_exp(dxi) @ T, scales + ds
    r = _edge_residual(torch.zeros((n, 6), dtype=T.dtype, device=T.device), scales, T,
                       edges["i"], edges["j"], edges["Z"], cfg.rot_weight)
    cost = reduce(torch.sum(edges["w"] * torch.sum(r * r, dim=-1)))
    return T, scales, cost


def _edges_on(edges: dict, device) -> dict:
    return {"i": torch.as_tensor(edges["i"], device=device).long(),
            "j": torch.as_tensor(edges["j"], device=device).long(),
            "Z": torch.as_tensor(edges["Z"], device=device),
            "w": torch.as_tensor(edges["w"], device=device)}


def optimize_pose_graph(
    T_init: torch.Tensor,
    edges: dict,
    cfg: PoseGraphConfig = PoseGraphConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Optimize a window of poses against relative-pose edges.

    T_init: [N, 4, 4] initial world<-frame poses, on the device where the
    solve runs. edges: {'i': [E] int, 'j': [E] int, 'Z': [E, 4, 4],
    'w': [E]}: measured T_i^-1 T_j with scalar weights (0 = padding).
    Returns (T_opt [N, 4, 4], scales [N], final_cost).
    """
    return _gauss_newton(T_init, _edges_on(edges, T_init.device), cfg, lambda s: s)


def _pad_edges(edges: dict, parts: int) -> dict:
    """Pad the edges to a multiple of ``parts`` with zero-weight edges
    (i = 0, j = 1, Z = identity), as the JAX package pads them: the weight
    makes the padding exact."""
    e = edges["i"].shape[0]
    pad = (-e) % parts
    if not pad:
        return edges
    Z_pad = torch.eye(4, dtype=edges["Z"].dtype, device=edges["Z"].device).expand(pad, 4, 4)
    return {"i": torch.cat([edges["i"], edges["i"].new_zeros(pad)]),
            "j": torch.cat([edges["j"], edges["j"].new_ones(pad)]),
            "Z": torch.cat([edges["Z"], Z_pad]),
            "w": torch.cat([edges["w"], edges["w"].new_zeros(pad)])}


def optimize_pose_graph_sharded(
    T_init: torch.Tensor,
    edges: dict,
    cfg: PoseGraphConfig = PoseGraphConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``optimize_pose_graph`` with the edges split over the ranks of the
    process group (``parallel/mesh.batch_group``). Every rank passes the
    whole edge set; it is padded to a multiple of the world size, and rank
    k takes the k-th contiguous block of it. Each iteration's five sums and
    the final cost are summed across the ranks, so every rank returns the
    same result. Without a process group it is ``optimize_pose_graph``.
    """
    from packnet_sfm_tpu_torch.parallel import mesh

    group = mesh.batch_group()
    if group is None:
        return optimize_pose_graph(T_init, edges, cfg)
    world, rank = mesh.process_count(), mesh.process_index()
    edges = _pad_edges(_edges_on(edges, T_init.device), world)
    per = edges["i"].shape[0] // world
    shard = {k: v[rank * per:(rank + 1) * per] for k, v in edges.items()}
    return _gauss_newton(T_init, shard, cfg, lambda s: mesh.all_reduce_sum(s, group))


def chain_relative_poses(relative: torch.Tensor) -> torch.Tensor:
    """[M, 4, 4] relative transforms Z_{k,k+1} -> [M+1, 4, 4] trajectory."""
    traj = [torch.eye(4, dtype=relative.dtype, device=relative.device)]
    for Z in relative:
        traj.append(traj[-1] @ Z)
    return torch.stack(traj)
