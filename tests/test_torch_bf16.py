"""The bfloat16 compute policy, module by module: the port against the JAX
package on the same numpy-seeded weights (``utils/convert.from_jax``) and
the same bfloat16 input bits, on the CPU.

The policy is flax's per-module compute dtype. PackNet's layers and PoseNet
take ``dtype``; the ResNet family takes none and computes in float32 on a
bfloat16 input (flax promotes it against the float32 weights).

- The dtype map: every module's output dtype equals JAX's, for a float32
  and a bfloat16 input, with the module's dtype unset and set to bfloat16.
- Parity in bfloat16. Each case runs JAX in bfloat16, JAX in float32 on the
  same (bfloat16-representable) input, and the port in bfloat16. Errors are
  the largest difference over the largest magnitude of the reference.
  Beside a direct bound (port against JAX's bfloat16 output), the port's
  error against the float32 result must be at most 2x JAX's own: a
  rounding point that JAX does not have would show there, whatever the
  direct tolerance. The direct bounds are about 3x what was measured
  (``python tests/test_torch_bf16.py`` prints both figures of every case):
  both round every layer's output to bfloat16 (8 bits), so they part by a
  few bfloat16 spacings wherever a sum lands near a rounding boundary.
- FastGroupNorm on the same bfloat16 input: within one bfloat16 spacing of
  JAX's output (both take float32 statistics and round once). At large
  means in bfloat16 compute JAX skips its mean shift; the port takes
  PyTorch's group norm on the float32 input, which needs no shift: its
  output is within one bfloat16 spacing of a float64 oracle on the same
  input bits (ROADMAP.md §3 (c)).
- PackNet's resize of a bfloat16 image (``jnp.linspace`` in bfloat16 for
  the source positions) is bit for bit JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.nn import layers as jlayers
from packnet_sfm_tpu.nn import packnet as jpacknet
from packnet_sfm_tpu.nn.depth_resnet import DepthResNet as JaxDepthResNet
from packnet_sfm_tpu.nn.posenet import PoseNet as JaxPoseNet
from packnet_sfm_tpu.nn.raysurface import RaySurfaceResNet as JaxRaySurfaceResNet
from packnet_sfm_tpu.ops import image as jimage
from packnet_sfm_tpu_torch.nn import layers as tlayers
from packnet_sfm_tpu_torch.nn import packnet as tpacknet
from packnet_sfm_tpu_torch.nn.depth_resnet import DepthResNet
from packnet_sfm_tpu_torch.nn.posenet import PoseNet
from packnet_sfm_tpu_torch.nn.raysurface import RaySurfaceResNet
from packnet_sfm_tpu_torch.ops import image as timage
from packnet_sfm_tpu_torch.utils.convert import from_jax

torch.set_num_threads(1)

BF16 = torch.bfloat16
JDT = {None: None, BF16: jnp.bfloat16}


def _bf16_values(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16, as float32."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _rand(shape, seed, scale=1.0, shift=0.0):
    x = np.random.default_rng(seed).normal(shift, scale, size=shape).astype(np.float32)
    return _bf16_values(x)


# Each case: (JAX module factory(dtype), port module factory(dtype), input
# [B, H, W, C], whether the port module is NCHW, direct tolerance). The
# tolerances are about 3x the measured figures printed by ``__main__``, and
# one bfloat16 spacing (2^-7 of the largest output) where the port gave
# JAX's bits: measured 0 (Conv2dBlock, two-step pack, unpack), 7.1e-3
# (ResidualBlock), 6.1e-8 (InvDepthHead: float32 out), 5.1e-3 and 2.4e-3
# (fused pack, k = 3 and 5), 5.5e-3 (pack5's path). Against float32 the
# port's error equalled JAX's in every case but pack5's (6.24e-3 against
# 6.31e-3).
def _cases():
    return {
        "conv2d_block": (
            lambda dt: jlayers.Conv2dBlock(32, 3, 1, dt),
            lambda dt: tlayers.Conv2dBlock(16, 32, 3, 1, dt),
            _rand((2, 12, 16, 16), 1), True, 1e-2),
        "residual_block": (
            lambda dt: jlayers.ResidualBlock(32, 2, 1, None, dt),
            lambda dt: tlayers.ResidualBlock(16, 32, 2, 1, None, dt),
            _rand((2, 12, 16, 16), 2), True, 2e-2),
        "inv_depth_head": (
            lambda dt: jlayers.InvDepthHead(1, dtype=dt),
            lambda dt: tlayers.InvDepthHead(32, 1, dtype=dt),
            _rand((2, 12, 16, 32), 3), True, 1e-6),
        "pack_fused": (
            lambda dt: jpacknet.PackLayerConv3d(16, 3, d=4, dtype=dt, mode="fused"),
            lambda dt: tpacknet.PackLayerConv3d(16, 3, d=4, mode="fused", dtype=dt),
            _rand((2, 16, 20, 16), 4), True, 1.5e-2),
        "pack_fused_k5": (
            lambda dt: jpacknet.PackLayerConv3d(16, 5, d=4, dtype=dt, mode="fused"),
            lambda dt: tpacknet.PackLayerConv3d(16, 5, d=4, mode="fused", dtype=dt),
            _rand((2, 16, 20, 16), 5), True, 1e-2),
        "pack_two_step": (
            lambda dt: jpacknet.PackLayerConv3d(16, 3, d=4, dtype=dt, mode="two_step"),
            lambda dt: tpacknet.PackLayerConv3d(16, 3, d=4, mode="two_step", dtype=dt),
            _rand((2, 16, 20, 16), 6), True, 1e-2),
        # pack5's path: Cp = 4 * 144 > 512, where JAX's 3D conv is 27 shifted
        # multiply-adds in the compute dtype (the port's is one Conv3d)
        "pack5_two_step": (
            lambda dt: jpacknet.PackLayerConv3d(144, 3, d=2, dtype=dt, mode="two_step"),
            lambda dt: tpacknet.PackLayerConv3d(144, 3, d=2, mode="two_step", dtype=dt),
            _rand((1, 4, 6, 144), 7), True, 1.5e-2),
        "unpack": (
            lambda dt: jpacknet.UnpackLayerConv3d(16, 3, d=4, dtype=dt),
            lambda dt: tpacknet.UnpackLayerConv3d(32, 16, 3, d=4, dtype=dt),
            _rand((2, 8, 10, 32), 8), True, 1e-2),
    }


CASES = _cases()


def _run_case(name):
    """(JAX bfloat16, JAX float32, port bfloat16) outputs of a case, NHWC
    float32, and the output dtypes (JAX's, the port's)."""
    jmod, tmod, x, nchw, _ = CASES[name]
    variables = _np(jmod(None).init(jax.random.PRNGKey(0), jnp.asarray(x)))
    j16 = jmod(jnp.bfloat16).apply(variables, jnp.asarray(x).astype(jnp.bfloat16))
    j32 = jmod(None).apply(variables, jnp.asarray(x))
    port = tmod(BF16)
    port.load_state_dict(from_jax(variables["params"]), strict=True)
    with torch.no_grad():
        t16 = port((_nchw(x) if nchw else torch.from_numpy(x)).to(BF16))
    return (np.asarray(j16, np.float32), np.asarray(j32, np.float32),
            _nhwc(t16) if nchw else t16.float().numpy(), (j16.dtype, t16.dtype))


@pytest.mark.parametrize("name", list(CASES))
def test_module_in_bf16_matches_jax(name):
    j16, j32, t16, (jdt, tdt) = _run_case(name)
    assert str(tdt).removeprefix("torch.") == str(jdt)
    assert np.all(np.isfinite(t16))
    assert _err(t16, j16) <= CASES[name][4]
    assert _err(t16, j32) <= 2 * _err(j16, j32)


# --- the dtype map ----------------------------------------------------------------

def _map_cases():
    x16 = _rand((1, 8, 8, 16), 9)
    img = _rand((1, 64, 64, 3), 10, 0.2, 0.5)
    return {
        "conv2d_block": (lambda dt: jlayers.Conv2dBlock(16, 3, 1, dt),
                         lambda dt: tlayers.Conv2dBlock(16, 16, 3, 1, dt), x16, "nchw"),
        "residual_block": (lambda dt: jlayers.ResidualBlock(16, 1, 1, None, dt),
                           lambda dt: tlayers.ResidualBlock(16, 16, 1, 1, None, dt), x16,
                           "nchw"),
        "inv_depth_head": (lambda dt: jlayers.InvDepthHead(1, dtype=dt),
                           lambda dt: tlayers.InvDepthHead(16, 1, dtype=dt), x16, "nchw"),
        "group_norm": (lambda dt: jlayers.FastGroupNorm(16, dtype=dt),
                       lambda dt: tlayers.FastGroupNorm(16, 16, dtype=dt), x16, "nchw"),
        "pack": (lambda dt: jpacknet.PackLayerConv3d(16, 3, d=4, dtype=dt),
                 lambda dt: tpacknet.PackLayerConv3d(16, 3, d=4, dtype=dt), x16, "nchw"),
        "unpack": (lambda dt: jpacknet.UnpackLayerConv3d(16, 3, d=4, dtype=dt),
                   lambda dt: tpacknet.UnpackLayerConv3d(16, 16, 3, d=4, dtype=dt), x16,
                   "nchw"),
        "posenet": (lambda dt: JaxPoseNet(dtype=dt), lambda dt: PoseNet(dtype=dt), img,
                    "pose"),
        "depth_resnet": (lambda dt: JaxDepthResNet(version="18"),
                         lambda dt: DepthResNet("18"), img, "depth"),
        "raysurface_resnet": (lambda dt: JaxRaySurfaceResNet(version="18"),
                              lambda dt: RaySurfaceResNet("18"), img, "depth"),
    }


MAP_CASES = _map_cases()


def _dtypes_of(out):
    if isinstance(out, dict):
        return {k: _dtypes_of(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return [_dtypes_of(v) for v in out]
    return str(out.dtype).removeprefix("torch.")


@pytest.mark.parametrize("module_dtype", [None, BF16], ids=["unset", "bfloat16"])
@pytest.mark.parametrize("input_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MAP_CASES))
def test_output_dtypes_match_jax(name, input_dtype, module_dtype):
    jmod, tmod, x, kind = MAP_CASES[name]
    jx = jnp.asarray(x).astype(input_dtype)
    tx = torch.from_numpy(x).to(getattr(torch, input_dtype))
    if kind == "pose":
        args_j, args_t = (jx, [jx, jx]), (tx, [tx, tx])
    elif kind == "depth":
        args_j, args_t = (jx,), (tx,)
    else:
        args_j, args_t = (jx,), (tx.permute(0, 3, 1, 2),)
    module = jmod(JDT[module_dtype])
    kw = {"train": False} if kind in ("pose", "depth") else {}
    variables = module.init(jax.random.PRNGKey(0), *args_j, **kw)
    want = _dtypes_of(module.apply(variables, *args_j, **kw))
    port = tmod(module_dtype)
    port.eval()
    with torch.no_grad():
        got = _dtypes_of(port(*args_t))
    assert got == want


# --- group norm, resize, networks from a bfloat16 image ---------------------------

@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_group_norm_in_bf16_within_one_spacing_of_jax(layout):
    x = _rand((2, 12, 16, 64), 11, 2.0, 1.0)
    rng = np.random.default_rng(12)
    scale = (rng.uniform(size=64) + 0.5).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias}}
    want = np.asarray(jlayers.FastGroupNorm(16, dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x).astype(jnp.bfloat16)), np.float32)
    norm = tlayers.FastGroupNorm(64, dtype=BF16)
    norm.load_state_dict(from_jax(variables["params"]))
    t = torch.from_numpy(x).to(BF16).permute(0, 3, 1, 2)
    if layout == "contiguous":
        t = t.contiguous()
    with torch.no_grad():
        got = norm(t)
    assert got.dtype == BF16
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -120))) - 7)
    assert np.all(np.abs(_nhwc(got) - want) <= spacing)


@pytest.mark.parametrize("mean,std", [(1e2, 1.0), (1e3, 30.0), (1e4, 300.0)])
def test_group_norm_in_bf16_at_large_means_within_one_spacing_of_the_oracle(mean, std):
    """bfloat16 compute, where JAX skips its mean shift: the port's output is
    the float64 oracle's on the same bfloat16 input, rounded once."""
    x = _rand((2, 8, 12, 64), 13, std, mean)
    xg = x.reshape(2, 8, 12, 16, 4).astype(np.float64)
    centred = xg - xg.mean(axis=(1, 2, 4), keepdims=True)
    want = (centred / np.sqrt((centred ** 2).mean(axis=(1, 2, 4), keepdims=True) + 1e-5)
            ).reshape(x.shape)
    with torch.no_grad():
        got = _nhwc(tlayers.FastGroupNorm(64, dtype=BF16)(
            torch.from_numpy(x).to(BF16).permute(0, 3, 1, 2)))
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -120))) - 7)
    assert np.all(np.abs(got - want) <= spacing)


@pytest.mark.parametrize("src,shape", [((64, 96), (32, 48)), ((64, 96), (16, 24)),
                                       ((64, 96), (8, 12)), ((64, 96), (128, 192)),
                                       ((64, 96), (75, 124)), ((8, 640), (4, 320)),
                                       ((384, 8), (96, 4))])
def test_bilinear_resize_of_a_bf16_image_is_jax_bit_for_bit(src, shape):
    """At 640 wide the clamp's bound, 639, is 640 in bfloat16: the gather's
    index is clamped as JAX's is."""
    x = _rand((2,) + src + (3,), 14, 0.3, 0.5)
    want = np.asarray(jimage.interpolate_image(jnp.asarray(x).astype(jnp.bfloat16), shape),
                      np.float32)
    got = timage.interpolate_image(torch.from_numpy(x).to(BF16), shape)
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), want)


def _network_errors(net):
    """Errors of each output of ``net`` from a bfloat16 image, port against
    JAX; the outputs must be float32."""
    jmod, tmod, img, kind = MAP_CASES[net]
    dt = BF16 if net == "posenet" else None
    module = jmod(JDT[dt])
    jx = jnp.asarray(img).astype(jnp.bfloat16)
    args_j = (jx, [jx, jx]) if kind == "pose" else (jx,)
    variables = _np(module.init(jax.random.PRNGKey(0), *args_j, train=False))
    want = module.apply(variables, *args_j, train=False)
    port = tmod(dt)
    port.load_state_dict(from_jax(variables["params"], variables.get("batch_stats")),
                         strict=True)
    port.eval()
    tx = torch.from_numpy(img).to(BF16)
    with torch.no_grad():
        got = port(tx, [tx, tx]) if kind == "pose" else port(tx)
    if kind == "pose":
        # and PoseNet's error against its float32 pose at most 2x JAX's
        want32 = JaxPoseNet().apply(variables, jnp.asarray(img), [jnp.asarray(img)] * 2,
                                    train=False)
        assert _err(got.numpy(), want32) <= 2 * _err(want, want32)
        pairs = [(got, want)]
    elif isinstance(got, dict):
        pairs = list(zip(got["inv_depths"], want["inv_depths"]))
        pairs.append((got["ray_surface"], want["ray_surface"]))
    else:
        pairs = list(zip(got, want))
    assert all(g.dtype == torch.float32 for g, _ in pairs)
    return [_err(g.numpy(), w) for g, w in pairs]


# measured: 4.9e-3 (DepthResNet, RaySurfaceResNet), 5.4e-3 (PoseNet)
NETWORK_TOL = {"depth_resnet": 1.5e-2, "raysurface_resnet": 1.5e-2, "posenet": 1.5e-2}


@pytest.mark.parametrize("net", list(NETWORK_TOL))
def test_network_from_a_bf16_image_matches_jax(net):
    """DepthResNet and RaySurfaceResNet take no dtype: float32 compute on
    the bfloat16 image (the port upcasts it before the fixed normalization,
    JAX after it, which is all that parts them). PoseNet in bfloat16, its
    error against float32 at most 2x JAX's (measured equal, 6.2e-3)."""
    assert max(_network_errors(net)) <= NETWORK_TOL[net]


if __name__ == "__main__":
    # Prints the figures the tolerances rest on:
    #   PYTHONPATH=. python tests/test_torch_bf16.py
    jax.config.update("jax_platforms", "cpu")
    for case in CASES:
        j16, j32, t16, _ = _run_case(case)
        print(f"{case}: port vs JAX bf16 {_err(t16, j16):.3e}; against float32: port "
              f"{_err(t16, j32):.3e}, JAX {_err(j16, j32):.3e}")
    for net in NETWORK_TOL:
        print(f"{net} from a bfloat16 image: port vs JAX {max(_network_errors(net)):.3e}")
