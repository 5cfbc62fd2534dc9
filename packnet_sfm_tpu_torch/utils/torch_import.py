"""Reference checkpoints into the port (the port's own copy of
``packnet_sfm_tpu/utils/torch_import.py``, numpy only).

Reference (PyTorch) state dicts of PackNet01/PackNetSlim01, PoseNet,
DepthResNet and PoseResNet, and torchvision ResNet encoders, map onto the
port's modules by name. The port names its submodules after the JAX
package's flax tree (``utils/convert.py``), so each converter walks the
reference's names exactly as the JAX package's converter does, builds that
tree, and names its leaves as ``utils/convert.from_jax`` names them. The
reference's tensors are in torch layout already, so no kernel is
transposed: the result equals the JAX converter followed by ``from_jax``
(``tests/test_torch_export_convert.py``). Each ``*_from_torch`` returns a
state dict of the network it names, keyed relative to it.

The ImageNet encoder artifact (an npz of the encoder's flax tree, flax
kernel layout, 'params/<path>' and 'stats/<path>' keys) is what
``engine/checkpoint.load_pretrained_encoder`` grafts; ``save_encoder_
artifact`` writes it from ``resnet_encoder_trees(..., flax_layout=True)``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from packnet_sfm_tpu_torch.utils.convert import _flatten, _torch_key


def _c2d_flax(w: np.ndarray) -> np.ndarray:
    """torch Conv2d [O, I, kh, kw] -> flax [kh, kw, I, O] (the artifact's
    layout)."""
    return np.transpose(w, (2, 3, 1, 0))


def _set(tree: Dict, path: Tuple[str, ...], leaf_name: str, value: np.ndarray):
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf_name] = value


def _state_dict(*trees: Mapping) -> Dict[str, torch.Tensor]:
    """Flax-named trees of torch-layout arrays -> a state dict, with the
    keys that ``utils/convert.from_jax`` gives."""
    return {_torch_key(path): torch.tensor(np.asarray(value, dtype=np.float32))
            for tree in trees for path, value in _flatten(tree)}


def state_dict_to_numpy(state_dict: Mapping) -> Dict[str, np.ndarray]:
    """A torch state dict as numpy arrays, copied (``.numpy()`` alone would
    be a view of the tensors' storage)."""
    out = {}
    for k, v in state_dict.items():
        arr = v.detach().cpu().numpy() if hasattr(v, "detach") else v
        out[k] = np.array(arr, copy=True)
    return out


def legacy_state_dict(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rename the keys of an older published ``.pth.tar`` state dict to the
    current reference naming: ``disp_network``/``pose_network`` (without
    the ``model.`` wrapper) become ``model.depth_net``/``model.pose_net``,
    and PackNet's ``conv3.0`` shortcut becomes ``conv3``."""
    out: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        key = f"model.{key}"
        if "disp_network" in key:
            key = key.replace("conv3.0.weight", "conv3.weight")
            key = key.replace("conv3.0.bias", "conv3.bias")
        for old, new in (("model.model.", "model."),
                         ("pose_network.", "pose_net."),
                         ("disp_network.", "depth_net.")):
            key = key.replace(old, new)
        out[key] = val
    return out


def _conv2d_block(sd, prefix: str, params: Dict, path: Tuple[str, ...]):
    """reference Conv2D (conv_base + normalize) -> Conv2dBlock."""
    _set(params, path + ("Conv_0",), "kernel", sd[f"{prefix}.conv_base.weight"])
    _set(params, path + ("Conv_0",), "bias", sd[f"{prefix}.conv_base.bias"])
    _set(params, path + ("GroupNorm_0",), "scale", sd[f"{prefix}.normalize.weight"])
    _set(params, path + ("GroupNorm_0",), "bias", sd[f"{prefix}.normalize.bias"])


def packnet_from_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A reference PackNet01/PackNetSlim01 state dict -> the port's
    PackNet. A residual shortcut may carry the dropout wrapper's name
    (``conv3.0``)."""
    params: Dict = {}
    _conv2d_block(sd, "pre_calc", params, ("pre_calc",))
    _conv2d_block(sd, "conv1", params, ("conv1",))
    for n in range(2, 6):
        i = 0
        while f"conv{n}.{i}.conv1.conv_base.weight" in sd:
            base = f"conv{n}.{i}"
            path = (f"conv{n}", f"ResidualConv_{i}")
            _conv2d_block(sd, f"{base}.conv1", params, path + ("Conv2dBlock_0",))
            _conv2d_block(sd, f"{base}.conv2", params, path + ("Conv2dBlock_1",))
            sc = f"{base}.conv3.0" if f"{base}.conv3.0.weight" in sd else f"{base}.conv3"
            _set(params, path + ("Conv_0",), "kernel", sd[f"{sc}.weight"])
            _set(params, path + ("Conv_0",), "bias", sd[f"{sc}.bias"])
            _set(params, path + ("GroupNorm_0",), "scale", sd[f"{base}.normalize.weight"])
            _set(params, path + ("GroupNorm_0",), "bias", sd[f"{base}.normalize.bias"])
            i += 1
    for n in range(1, 6):
        _set(params, (f"pack{n}", "Conv_0"), "kernel", sd[f"pack{n}.conv3d.weight"])
        _set(params, (f"pack{n}", "Conv_0"), "bias", sd[f"pack{n}.conv3d.bias"])
        _conv2d_block(sd, f"pack{n}.conv", params, (f"pack{n}", "Conv2dBlock_0"))
        _set(params, (f"unpack{n}", "Conv_0"), "kernel", sd[f"unpack{n}.conv3d.weight"])
        _set(params, (f"unpack{n}", "Conv_0"), "bias", sd[f"unpack{n}.conv3d.bias"])
        _conv2d_block(sd, f"unpack{n}.conv", params, (f"unpack{n}", "Conv2dBlock_0"))
        _conv2d_block(sd, f"iconv{n}", params, (f"iconv{n}",))
    for n in range(1, 5):
        _set(params, (f"disp{n}", "Conv_0"), "kernel", sd[f"disp{n}_layer.conv1.weight"])
        _set(params, (f"disp{n}", "Conv_0"), "bias", sd[f"disp{n}_layer.conv1.bias"])
    return _state_dict(params)


def posenet_from_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A reference PoseNet state dict -> the port's PoseNet."""
    params: Dict = {}
    for i in range(1, 8):
        _set(params, (f"conv{i}", "Conv_0"), "kernel", sd[f"conv{i}.0.weight"])
        _set(params, (f"conv{i}", "Conv_0"), "bias", sd[f"conv{i}.0.bias"])
        _set(params, (f"conv{i}", "GroupNorm_0"), "scale", sd[f"conv{i}.1.weight"])
        _set(params, (f"conv{i}", "GroupNorm_0"), "bias", sd[f"conv{i}.1.bias"])
    _set(params, ("pose_pred",), "kernel", sd["pose_pred.weight"])
    _set(params, ("pose_pred",), "bias", sd["pose_pred.bias"])
    return _state_dict(params)


def _bn(sd, prefix: str, params: Dict, stats: Dict, path: Tuple[str, ...]):
    _set(params, path, "scale", sd[f"{prefix}.weight"])
    _set(params, path, "bias", sd[f"{prefix}.bias"])
    _set(stats, path, "mean", sd[f"{prefix}.running_mean"])
    _set(stats, path, "var", sd[f"{prefix}.running_var"])


def resnet_encoder_trees(sd: Mapping[str, np.ndarray], prefix: str = "encoder.",
                         flax_layout: bool = False) -> Tuple[Dict, Dict]:
    """A torchvision ResNet state dict (under ``prefix``) -> the encoder's
    flax-named (params, batch_stats) trees, kernels in torch layout, or in
    flax layout for the artifact where ``flax_layout``."""
    conv = _c2d_flax if flax_layout else (lambda w: w)
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    params: Dict = {}
    stats: Dict = {}
    _set(params, ("conv1",), "kernel", conv(sd["conv1.weight"]))
    _bn(sd, "bn1", params, stats, ("bn1", "BatchNorm_0"))
    pat = re.compile(r"layer(\d)\.(\d+)\.conv1\.weight")
    blocks = sorted({(int(m.group(1)), int(m.group(2))) for k in sd if (m := pat.match(k))})
    for layer, b in blocks:
        base = f"layer{layer}.{b}"
        path = (f"layer{layer}_{b}",)
        for ci in (1, 2, 3):
            if f"{base}.conv{ci}.weight" not in sd:
                continue
            _set(params, path + (f"conv{ci}",), "kernel", conv(sd[f"{base}.conv{ci}.weight"]))
            _bn(sd, f"{base}.bn{ci}", params, stats, path + (f"bn{ci}", "BatchNorm_0"))
        if f"{base}.downsample.0.weight" in sd:
            _set(params, path + ("downsample_conv",), "kernel",
                 conv(sd[f"{base}.downsample.0.weight"]))
            _bn(sd, f"{base}.downsample.1", params, stats,
                path + ("downsample_bn", "BatchNorm_0"))
    return params, stats


def resnet_encoder_from_torch(sd: Mapping[str, np.ndarray],
                              prefix: str = "encoder.") -> Dict[str, torch.Tensor]:
    """A torchvision ResNet state dict -> the port's ResNet encoder (its
    BatchNorm statistics included). ``prefix`` strips e.g. the reference's
    ``encoder.encoder.`` nesting."""
    return _state_dict(*resnet_encoder_trees(sd, prefix))


def _depth_decoder_tree(sd: Mapping[str, np.ndarray], prefix: str) -> Dict:
    """The reference DepthDecoder's ModuleList (``decoder.{idx}``: idx 0..9
    the upconvs (i, j) for i = 4..0, j = 0..1, idx 10..13 the dispconvs
    0..3) -> its flax-named tree."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    params: Dict = {}
    idx = 0
    for i in range(4, -1, -1):
        for j in range(2):
            _set(params, (f"upconv_{i}_{j}", "conv"), "kernel", sd[f"decoder.{idx}.conv.conv.weight"])
            _set(params, (f"upconv_{i}_{j}", "conv"), "bias", sd[f"decoder.{idx}.conv.conv.bias"])
            idx += 1
    for s in range(4):
        _set(params, (f"dispconv_{s}", "conv"), "kernel", sd[f"decoder.{idx}.conv.weight"])
        _set(params, (f"dispconv_{s}", "conv"), "bias", sd[f"decoder.{idx}.conv.bias"])
        idx += 1
    return params


def _pose_decoder_tree(sd: Mapping[str, np.ndarray], prefix: str) -> Dict:
    """The reference PoseDecoder's ``net.{0..3}`` -> its flax-named tree."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    params: Dict = {}
    for i, name in enumerate(["squeeze", "pose_0", "pose_1", "pose_2"]):
        _set(params, (name,), "kernel", sd[f"net.{i}.weight"])
        _set(params, (name,), "bias", sd[f"net.{i}.bias"])
    return params


def depth_decoder_from_torch(sd: Mapping[str, np.ndarray],
                             prefix: str = "decoder.") -> Dict[str, torch.Tensor]:
    """A reference DepthDecoder state dict -> the port's depth decoder."""
    return _state_dict(_depth_decoder_tree(sd, prefix))


def pose_decoder_from_torch(sd: Mapping[str, np.ndarray],
                            prefix: str = "decoder.") -> Dict[str, torch.Tensor]:
    """A reference PoseDecoder state dict -> the port's pose decoder."""
    return _state_dict(_pose_decoder_tree(sd, prefix))


def _resnet_from_torch(sd: Mapping[str, np.ndarray], decoder) -> Dict[str, torch.Tensor]:
    enc_p, enc_s = resnet_encoder_trees(sd, prefix="encoder.encoder.")
    return _state_dict({"encoder": enc_p, "decoder": decoder(sd, "decoder.")},
                       {"encoder": enc_s})


def depth_resnet_from_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A whole reference DepthResNet -> the port's DepthResNet."""
    return _resnet_from_torch(sd, _depth_decoder_tree)


def pose_resnet_from_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A whole reference PoseResNet -> the port's PoseResNet."""
    return _resnet_from_torch(sd, _pose_decoder_tree)


# The reference's names of the port's tensors: the inverse of the converters
# above, so that a port model's weights can be written as a reference-format
# checkpoint.

_BLOCK = ((r"\.conv\.(weight|bias)$", r".conv_base.\1"),
          (r"\.norm\.(weight|bias)$", r".normalize.\1"))


def _sub(key: str, rules) -> str:
    for pat, rep in rules:
        key = re.sub(pat, rep, key)
    return key


def _packnet_name(key: str) -> str:
    m = re.match(r"conv(\d)\.ResidualConv_(\d+)\.(.*)$", key)
    if m:
        n, i, rest = m.groups()
        for port, ref in (("Conv2dBlock_0", "conv1"), ("Conv2dBlock_1", "conv2")):
            if rest.startswith(port):
                return _sub(f"conv{n}.{i}.{ref}{rest[len(port):]}", _BLOCK)
        return f"conv{n}.{i}." + _sub(rest, ((r"^conv\.", "conv3."), (r"^norm\.", "normalize.")))
    m = re.match(r"(un)?pack(\d)\.(.*)$", key)
    if m:
        un, n, rest = m.groups()
        if rest.startswith("conv."):
            return f"{un or ''}pack{n}.conv3d.{rest[len('conv.'):]}"
        return _sub(f"{un or ''}pack{n}.conv{rest[len('Conv2dBlock_0'):]}", _BLOCK)
    m = re.match(r"disp(\d)\.conv\.(.*)$", key)
    if m:
        return f"disp{m.group(1)}_layer.conv1.{m.group(2)}"
    return _sub(key, _BLOCK)


def _posenet_name(key: str) -> str:
    return _sub(key, ((r"^(conv\d)\.conv\.", r"\1.0."), (r"^(conv\d)\.norm\.", r"\1.1.")))


def _encoder_name(key: str) -> str:
    return _sub(key, ((r"^layer(\d)_(\d+)\.", r"layer\1.\2."),
                      (r"downsample_conv\.", "downsample.0."),
                      (r"downsample_bn\.", "downsample.1.")))


_POSE_DECODER = ("squeeze", "pose_0", "pose_1", "pose_2")


def _decoder_name(key: str) -> str:
    m = re.match(r"upconv_(\d)_(\d)\.conv\.(.*)$", key)
    if m:
        i, j, leaf = int(m.group(1)), int(m.group(2)), m.group(3)
        return f"decoder.{(4 - i) * 2 + j}.conv.conv.{leaf}"
    m = re.match(r"dispconv_(\d)\.conv\.(.*)$", key)
    if m:
        return f"decoder.{10 + int(m.group(1))}.conv.{m.group(2)}"
    name, leaf = key.split(".", 1)
    return f"net.{_POSE_DECODER.index(name)}.{leaf}"


def _resnet_name(key: str) -> str:
    net, rest = key.split(".", 1)
    if net == "encoder":
        return "encoder.encoder." + _encoder_name(rest)
    return "decoder." + _decoder_name(rest)


REFERENCE_NAMES = {"PackNet01": _packnet_name, "PackNetSlim01": _packnet_name,
                   "PoseNet": _posenet_name, "DepthResNet": _resnet_name,
                   "PoseResNet": _resnet_name, "ResNetEncoder": _encoder_name}


def reference_name(network: torch.nn.Module, key: str) -> str:
    """The PyTorch reference's name of ``network``'s state-dict ``key``, for
    the networks that the converters take (what ``*_from_torch`` maps back
    to ``key``)."""
    kind = type(network).__name__
    if kind not in REFERENCE_NAMES:
        raise ValueError(f"no reference naming for {kind}")
    return REFERENCE_NAMES[kind](key)


def reference_state_dict(model) -> Dict[str, torch.Tensor]:
    """A port SfmModel's weights under the reference's names
    ('model.depth_net.*', 'model.pose_net.*'), as a reference checkpoint's
    'state_dict' holds them."""
    out = {}
    for attr in ("depth_net", "pose_net"):
        net = getattr(model, attr, None)
        if net is not None:
            out.update({f"model.{attr}.{reference_name(net, k)}": v.detach().clone()
                        for k, v in net.state_dict().items()})
    return out


def adapt_conv1_multiimage(kernel: np.ndarray, num_input_images: int) -> np.ndarray:
    """Widen a flax conv1 kernel [kh, kw, 3, 64] for stacked-frame input:
    tiled across the input-channel axis and divided by the image count, so
    that activations keep their scale."""
    if num_input_images <= 1:
        return kernel
    return np.concatenate([kernel] * num_input_images, axis=2) / num_input_images


def _flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_encoder_artifact(path: str, params: Dict, stats: Dict):
    """Write an encoder's flax-layout (params, batch_stats) trees as the npz
    artifact that ``pretrained_path`` configs name."""
    flat = {f"params/{k}": v for k, v in _flatten_tree(params).items()}
    flat.update({f"stats/{k}": v for k, v in _flatten_tree(stats).items()})
    np.savez(path, **flat)


def load_encoder_artifact(path: str) -> Tuple[Dict, Dict]:
    """Read an encoder-weights npz artifact -> (params, batch_stats)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = _unflatten_tree(
        {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")})
    stats = _unflatten_tree(
        {k[len("stats/"):]: v for k, v in flat.items() if k.startswith("stats/")})
    return params, stats
