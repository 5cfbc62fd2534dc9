"""Folded 3D conv over packed channels, and its exact fusion with the
following 2D conv: the PackNet "pack" layer (port of ``ops/fold_conv.py``).

The pack layer is ``Conv3d(1, d, 3)`` over [B, 1, Cp, H, W], a channel fold
to d*Cp channels (folded channel ``j*Cp + c``) and a 2D conv
``d*Cp -> C`` of size k, with no nonlinearity in between. Two formulations:

- ``channel_conv3d``: the 3D conv alone, emitting the folded layout;
- ``fused_pack_conv``: conv3d, fold and conv2d collapsed algebraically into
  one (k+2)x(k+2) convolution over the unexpanded Cp channels. The
  composition is linear, so the merged kernel
  ``K[a+h, b+x, c', o] = sum_{z,j} w3[z,h,x,j] * w2[a, b, j*Cp + c'-z+1, o]``
  is exact in the interior. At the image border the two-step path zero-pads
  the intermediate, which the merged conv does not; the difference is
  subtracted in closed form (ring, corner and bias corrections), so the
  result equals ``pack_conv_two_step`` at every pixel up to float rounding.
  Gradients flow through the merged-kernel construction to both weights.

Activations are NHWC at these functions, as in the JAX package; weights are
in PyTorch's layout (``w3`` [d, 1, 3, 3, 3] with the kernel's depth axis
over channels, ``w2`` [Cout, d*Cp, k, k]), which is what the modules hold.
The convolutions and einsums are PyTorch's; the permutes around them are
views.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# mode="auto" takes the two-step path below this many output positions
# (B*H*W), where the per-call construction of the merged kernel does not pay
# for the smaller convolution. The value is the JAX package's, kept so that
# both packages take the same branch; the crossover on the card is not
# measured yet.
_FUSE_MIN_POSITIONS = 2048


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def channel_conv3d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """3x3x3 conv over (channel-as-depth, H, W) emitting the folded layout.

    x: [B, H, W, Cp]; kernel: [d, 1, 3, 3, 3] (d, 1, kz, kh, kx); bias: [d].
    Returns [B, H, W, d*Cp] with channel index j*Cp + c (j = 3D feature).
    """
    b, h, w, cp = x.shape
    d = kernel.shape[0]
    y = F.conv3d(_nchw(x).unsqueeze(1), kernel, bias, padding=1)     # [B, d, Cp, H, W]
    return _nhwc(y.reshape(b, d * cp, h, w))


def conv2d_same(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Raw 2D conv with zero 'same' padding: x [B, H, W, Cin], kernel
    [Cout, Cin, k, k] (no norm, no activation)."""
    return _nhwc(F.conv2d(_nchw(x), kernel, bias, padding=kernel.shape[-1] // 2))


def pack_conv_two_step(x: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Two-step pack conv in the order of the definition (3D conv, fold,
    2D conv)."""
    return conv2d_same(channel_conv3d(x, w3, b3), w2, b2)


def _shift_cp(t: torch.Tensor, z: int) -> torch.Tensor:
    """Shift the Cp (second-to-last) axis for 3D-conv tap z: input channel c'
    contributes via intermediate channel c = c'-z+1, zero at the fold edges."""
    if z == 0:
        return torch.cat([t[..., 1:, :], torch.zeros_like(t[..., :1, :])], dim=-2)
    if z == 2:
        return torch.cat([torch.zeros_like(t[..., :1, :]), t[..., :-1, :]], dim=-2)
    return t


def _shift_cp3(t: torch.Tensor) -> torch.Tensor:
    """Stack the three z-shifted copies of ``t`` along a new leading axis."""
    return torch.stack([_shift_cp(t, z) for z in range(3)])


def _placement(k2: int, like: torch.Tensor) -> torch.Tensor:
    """One-hot P[h, u, a] = [u == h + a], h in 0..2, a in 0..k2-1: places
    tap (h, x) at kernel offset (h+a, x+b) by a contraction."""
    h = torch.arange(3, device=like.device)[:, None, None]
    u = torch.arange(k2 + 2, device=like.device)[None, :, None]
    a = torch.arange(k2, device=like.device)[None, None, :]
    return (u == h + a).to(like.dtype)


def _merged_kernel(w3f: torch.Tensor, w2f: torch.Tensor, cp: int) -> torch.Tensor:
    """Collapse conv3d, fold and conv2d into one [k+2, k+2, Cp, Cout] kernel.

    w3f: [3 (kz), 3, 3, d]; w2f: [k, k, d*Cp, Cout]. Valid in the interior.
    """
    k2, d, cout = w2f.shape[0], w3f.shape[-1], w2f.shape[-1]
    w2z = _shift_cp3(w2f.reshape(k2, k2, d, cp, cout))          # [3,k,k,d,cp,cout]
    tap = torch.einsum("zhxj,zabjpo->hxabpo", w3f, w2z)
    p = _placement(k2, w2f)
    return torch.einsum("hua,xvb,hxabpo->uvpo", p, p, tap)


def _merged_border_kernels4(w3_sl: torch.Tensor, w2_sel: torch.Tensor, cp: int) -> torch.Tensor:
    """The four border rings' 1D merged kernels in one batched construction.

    w3_sl: [4, 3 (kz), 3 (kt), d], per ring the w3 plane whose fixed tap
    produced it (kh=2 for top, kh=0 bottom, kx=2 left, kx=0 right); kt is
    the in-ring spatial tap. w2_sel: [4, m, k2, d*Cp, Cout], the w2 rows (or
    columns) that hit each ring for each of the m border output rows.
    Returns [4, m, k2+2, Cp, Cout].
    """
    q, n, k2 = w2_sel.shape[:3]
    d, cout = w3_sl.shape[-1], w2_sel.shape[-1]
    w2z = _shift_cp3(w2_sel.reshape(q, n, k2, d, cp, cout))     # [3,4,m,k2,d,cp,cout]
    tap = torch.einsum("qzkj,zqnbjpo->qknbpo", w3_sl, w2z)
    return torch.einsum("kub,qknbpo->qnupo", _placement(k2, w2_sel), tap)


def _ring_vec4(x_px: torch.Tensor, w3_col: torch.Tensor, cp: int) -> torch.Tensor:
    """The four corners' ring values: x_px [4, B, Cp] (the corner pixels),
    w3_col [4, 3 (kz), d] -> [4, B, d*Cp] folded (j-major)."""
    xp = F.pad(x_px, (1, 1))
    shifts = torch.stack([xp[..., kz:kz + cp] for kz in range(3)])   # [3,4,B,Cp]
    return torch.einsum("qzj,zqbc->qbjc", w3_col, shifts).reshape(4, x_px.shape[1], -1)


def build_fused_kernels(w3: torch.Tensor, b3: torch.Tensor, w2: torch.Tensor,
                        b2: torch.Tensor, cp: int) -> dict:
    """Every weight-only tensor the fused pack conv needs, as a dict.

    Split from the application so the construction can be timed on its own
    and reused where it is loop-invariant. Inside, kernels are laid out
    [kh, kw, in, out] as in the JAX package; the convolution weights that
    ``apply_fused_kernels`` hands to ``F.conv2d`` are stored [out, in, kh, kw].
    """
    cout, _, k2, _ = w2.shape
    m = k2 // 2
    d = w3.shape[0]
    w3f = w3[:, 0].permute(1, 2, 3, 0)                           # [kz, kh, kx, d]
    w2f = w2.permute(2, 3, 1, 0)                                 # [k, k, d*Cp, cout]

    kk = _merged_kernel(w3f, w2f, cp)
    # the 3D-conv bias reaches every interior output through all k2*k2 taps
    w2r = w2f.reshape(k2, k2, d, cp, cout)
    b_eff = b2 + torch.einsum("abjpo,j->o", w2r, b3)
    out = {"kk": kk.permute(3, 2, 0, 1), "b_eff": b_eff}

    dev = w2.device
    i_near = torch.tensor([m - 1 - p for p in range(m)], device=dev)   # rows/cols 0..m-1
    i_far = torch.tensor([m + 1 + t for t in range(m)], device=dev)    # rows/cols H-1-t/W-1-t

    # Ring corrections: top/bottom rings (from x row 0 / H-1 via the w3
    # kh=2 / kh=0 planes), left/right (x col 0 / W-1 via kx=2 / kx=0). All
    # four ring kernels are built in one batched construction and applied as
    # two grouped convs (top+bottom share the horizontal conv, left+right the
    # vertical).
    w3_sl = torch.stack([w3f[:, 2], w3f[:, 0], w3f[:, :, 2], w3f[:, :, 0]])
    w2_sel = torch.stack([
        w2f[i_near], w2f[i_far],
        w2f[:, i_near].permute(1, 0, 2, 3),
        w2f[:, i_far].permute(1, 0, 2, 3)])                      # [4,m,k2,dCp,cout]
    kk4 = _merged_border_kernels4(w3_sl, w2_sel, cp)             # [4,m,k2+2,cp,cout]

    def _k1(kern):                       # [m,k2+2,cp,cout] -> [k2+2,cp,m*cout]
        return kern.permute(1, 2, 0, 3).reshape(k2 + 2, cp, m * cout)

    # grouped-conv weights [2*m*cout, cp, kh, kw]; group 0 = near edge
    out["k_h"] = torch.cat([_k1(kk4[0]), _k1(kk4[1])], dim=-1)[None].permute(3, 2, 0, 1)
    out["k_v"] = torch.cat([_k1(kk4[2]), _k1(kk4[3])], dim=-1)[:, None].permute(3, 2, 0, 1)

    # Corner pieces (see apply: corner ring values are subtracted twice).
    out["w3c4"] = torch.stack([w3f[:, 2, 2], w3f[:, 2, 0], w3f[:, 0, 2], w3f[:, 0, 0]])
    out["sel4"] = torch.stack([
        w2f[i_near][:, i_near], w2f[i_near][:, i_far],
        w2f[i_far][:, i_near], w2f[i_far][:, i_far]])            # [4,m,m,dCp,cout]

    # Bias correction: b_eff assumed the 3D-conv bias at every z tap, but the
    # two-step path has bias only inside the image. Subtract the taps whose z
    # position is outside (inclusion-exclusion for the corners).
    w2b = torch.einsum("abjpo,j->abo", w2r, b3)                  # [k2,k2,cout]
    rowsum, colsum = w2b.sum(1), w2b.sum(0)
    out["bias_top"] = torch.stack([rowsum[: m - p].sum(0) for p in range(m)])
    out["bias_bot"] = torch.stack([rowsum[m + 1 + t:].sum(0) for t in range(m)])
    out["bias_left"] = torch.stack([colsum[: m - q].sum(0) for q in range(m)])
    out["bias_right"] = torch.stack([colsum[m + 1 + u:].sum(0) for u in range(m)])
    out["bc_tl"] = torch.stack([torch.stack([w2b[: m - p, : m - q].sum((0, 1))
                                             for q in range(m)]) for p in range(m)])
    out["bc_tr"] = torch.stack([torch.stack([w2b[: m - p, m + 1 + u:].sum((0, 1))
                                             for u in range(m)]) for p in range(m)])
    out["bc_bl"] = torch.stack([torch.stack([w2b[m + 1 + t:, : m - q].sum((0, 1))
                                             for q in range(m)]) for t in range(m)])
    out["bc_br"] = torch.stack([torch.stack([w2b[m + 1 + t:, m + 1 + u:].sum((0, 1))
                                             for u in range(m)]) for t in range(m)])
    return out


def apply_fused_kernels(x: torch.Tensor, kn: dict, k2: int, cout: int) -> torch.Tensor:
    """Apply pre-built fused kernels (``build_fused_kernels``) to x
    [B, H, W, Cp]. The border corrections are slice updates of the merged
    conv's output through an NHWC view, in place: autograd records them."""
    b, h, w, cp = x.shape
    m = k2 // 2
    xc = _nchw(x)
    y = _nhwc(F.conv2d(xc, kn["kk"], kn["b_eff"], padding=m + 1))

    x_h = torch.cat([xc[:, :, :1], xc[:, :, -1:]], dim=1)        # [B,2Cp,1,W]
    out_h = _nhwc(F.conv2d(x_h, kn["k_h"], padding=(0, m + 1), groups=2))
    out_h = out_h.reshape(b, w, 2, m, cout)
    d_top = out_h[:, :, 0].permute(0, 2, 1, 3)                   # [B,m,W,cout]
    d_bot = out_h[:, :, 1].permute(0, 2, 1, 3).flip(1)           # t -> row H-1-t

    x_v = torch.cat([xc[:, :, :, :1], xc[:, :, :, -1:]], dim=1)  # [B,2Cp,H,1]
    out_v = _nhwc(F.conv2d(x_v, kn["k_v"], padding=(m + 1, 0), groups=2))
    out_v = out_v.reshape(b, h, 2, m, cout)
    d_left = out_v[:, :, 0]                                      # [B,H,m,cout]
    d_right = out_v[:, :, 1].flip(2)

    y[:, :m] -= d_top
    y[:, -m:] -= d_bot
    y[:, :, :m] -= d_left
    y[:, :, -m:] -= d_right

    # Corner ring values were subtracted by both their row and their column
    # correction: add each back once.
    px4 = torch.stack([x[:, 0, 0], x[:, 0, -1], x[:, -1, 0], x[:, -1, -1]])
    vec4 = _ring_vec4(px4, kn["w3c4"], cp)                       # [4,B,dCp]
    delta4 = torch.einsum("qstco,qbc->qbsto", kn["sel4"], vec4)
    y[:, :m, :m] += delta4[0]
    y[:, :m, -m:] += delta4[1].flip(2)
    y[:, -m:, :m] += delta4[2].flip(1)
    y[:, -m:, -m:] += delta4[3].flip(1, 2)

    y[:, :m] -= kn["bias_top"][None, :, None]
    y[:, -m:] -= kn["bias_bot"].flip(0)[None, :, None]
    y[:, :, :m] -= kn["bias_left"][None, None]
    y[:, :, -m:] -= kn["bias_right"].flip(0)[None, None]
    y[:, :m, :m] += kn["bc_tl"][None]
    y[:, :m, -m:] += kn["bc_tr"].flip(1)[None]
    y[:, -m:, :m] += kn["bc_bl"].flip(0)[None]
    y[:, -m:, -m:] += kn["bc_br"].flip(0, 1)[None]
    return y


def fused_pack_conv(x: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    """Exact pack conv as one conv over Cp channels plus the border fix.

    x: [B, H, W, Cp]; w3: [d, 1, 3, 3, 3]; w2: [Cout, d*Cp, k, k]. The output
    equals ``pack_conv_two_step`` at every pixel up to float rounding.

    mode: 'auto' picks fused or two-step by ``_FUSE_MIN_POSITIONS``; 'fused'
    forces the merged-kernel path; 'two_step' the two-step path. An image
    too small for disjoint border regions always takes the two-step path.
    """
    if mode not in ("auto", "fused", "two_step"):
        raise ValueError(f"unknown pack conv mode {mode!r}")
    b, h, w, cp = x.shape
    cout, _, k2, _ = w2.shape
    m = k2 // 2
    if h < 2 * m + 2 or w < 2 * m + 2:
        return pack_conv_two_step(x, w3, b3, w2, b2)
    if mode == "two_step" or (mode == "auto" and b * h * w < _FUSE_MIN_POSITIONS):
        return pack_conv_two_step(x, w3, b3, w2, b2)
    return apply_fused_kernels(x, build_fused_kernels(w3, b3, w2, b2, cp), k2, cout)
