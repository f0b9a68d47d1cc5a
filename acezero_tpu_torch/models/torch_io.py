"""Checkpoint loading and saving for the port.

Encoders (`weights/*.pt`) are torch state dicts of Conv2d layers, loaded as
they are (OIHW). Heads (ACE `iterationX.pt`, fp16) are 1x1-conv state dicts
whose architecture is inferred from the keys, as the reference does: the
extra-block count from `<i>c0.weight`, homogeneous output from fc3's width.
`save_head` writes the same keys (and the scale buffers) as the JAX
package's writer, fp16 by default, so either package reads the other's
file. Depth heads (`weights/tpu_depth_v*.pt`, `d_conv1..4`) are conv state
dicts like the encoders; `save_encoder` writes encoders and depth heads
in the JAX package's layout (`<layer>.weight` OIHW f32, `<layer>.bias`), so
either package loads the other's file. `params_from_jax` converts the JAX
package's numpy parameter trees (HWIO convs, (cin, cout) dense layers) into
the port's layout.
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import torch

from acezero_tpu_torch.models.head import HeadConfig

_HEAD_DENSE_KEYS = ["res3_conv1", "res3_conv2", "res3_conv3", "fc1", "fc2", "fc3", "head_skip"]


def load_state_dict(path: str | Path) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().float() for k, v in sd.items()}


def _to(params, device):
    if isinstance(params, dict):
        return {k: _to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [_to(v, device) for v in params]
    return params.to(device)


def import_encoder_state_dict(sd: dict, device="cpu") -> dict:
    """Encoder state dict -> {name: {"w": OIHW, "b": (cout,)}} in f32."""
    params = {}
    for key in sd:
        if key.endswith(".weight"):
            name = key[: -len(".weight")]
            params[name] = {"w": sd[key].contiguous(), "b": sd[name + ".bias"]}
    return _to(params, device)


def _dense(w: torch.Tensor) -> torch.Tensor:
    """1x1 conv weight (cout, cin, 1, 1) -> dense (cin, cout)."""
    return w[:, :, 0, 0].t().contiguous()


def import_head_state_dict(sd: dict, device="cpu") -> tuple[HeadConfig, dict]:
    """Head state dict -> (HeadConfig, head params) with the architecture
    inferred from the weights."""
    pattern = re.compile(r"^(\d+)c0\.weight$")
    num_blocks = sum(1 for k in sd if pattern.match(k))
    kwargs = {}
    if "max_scale" in sd:
        kwargs["homogeneous_max_scale"] = float(sd["max_scale"].reshape(-1)[0])
        kwargs["homogeneous_min_scale"] = float(sd["min_scale"].reshape(-1)[0])
    cfg = HeadConfig(
        num_head_blocks=num_blocks,
        use_homogeneous=sd["fc3.weight"].shape[0] == 4,
        in_channels=sd["res3_conv1.weight"].shape[1],
        head_channels=sd["res3_conv1.weight"].shape[0],
        **kwargs,
    )
    params: dict = {"blocks": []}
    for key in _HEAD_DENSE_KEYS:
        if key + ".weight" in sd:
            params[key] = {"w": _dense(sd[key + ".weight"]), "b": sd[key + ".bias"]}
    for i in range(num_blocks):
        params["blocks"].append(
            {f"c{j}": {"w": _dense(sd[f"{i}c{j}.weight"]), "b": sd[f"{i}c{j}.bias"]} for j in range(3)}
        )
    params["mean"] = sd["mean"].reshape(3)
    return cfg, _to(params, device)


def load_encoder(path: str | Path, device="cpu") -> dict:
    return import_encoder_state_dict(load_state_dict(path), device)


def load_depth_head(path: str | Path, device="cpu") -> dict:
    """A seed-depth head {d_conv1..4: {"w": OIHW, "b"}} in f32."""
    params = import_encoder_state_dict(load_state_dict(path), device)
    missing = [k for k in ("d_conv1", "d_conv2", "d_conv3", "d_conv4") if k not in params]
    if missing:
        raise ValueError(f"{path}: not a depth head (no {', '.join(missing)})")
    return params


def load_head(path: str | Path, device="cpu") -> tuple[HeadConfig, dict]:
    return import_head_state_dict(load_state_dict(path), device)


def export_head_state_dict(params: dict, cfg: HeadConfig, half: bool = True) -> dict:
    """Head params -> torch state dict of 1x1 convs (fp16 by default), with
    the reference's keys and scale buffers."""

    def t(x):
        out = x.detach().to("cpu", torch.float32).clone()
        return out.half() if half else out

    def conv(w):
        return t(w).t().contiguous()[:, :, None, None]

    sd = {}
    for key in _HEAD_DENSE_KEYS:
        if key in params:
            sd[key + ".weight"] = conv(params[key]["w"])
            sd[key + ".bias"] = t(params[key]["b"])
    for i, block in enumerate(params["blocks"]):
        for j in range(3):
            sd[f"{i}c{j}.weight"] = conv(block[f"c{j}"]["w"])
            sd[f"{i}c{j}.bias"] = t(block[f"c{j}"]["b"])
    if cfg.use_homogeneous:
        # numpy float32 arithmetic, as the JAX package's writer computes them
        max_scale = np.array([cfg.homogeneous_max_scale], np.float32)
        min_scale = np.array([cfg.homogeneous_min_scale], np.float32)
        h_beta = np.array([math.log(2.0) / (1.0 - 1.0 / max_scale[0])], np.float32)
        for key, val in (("max_scale", max_scale), ("min_scale", min_scale),
                         ("max_inv_scale", 1.0 / max_scale), ("h_beta", h_beta),
                         ("min_inv_scale", 1.0 / min_scale)):
            sd[key] = t(torch.from_numpy(val))
    sd["mean"] = t(params["mean"]).reshape(1, 3, 1, 1)
    return sd


def save_head(path: str | Path, params: dict, cfg: HeadConfig, half: bool = True) -> None:
    torch.save(export_head_state_dict(params, cfg, half=half), str(path))


def export_encoder_state_dict(params: dict, half: bool = False) -> dict:
    """Conv params {name: {"w": OIHW, "b"}} -> the JAX package's encoder
    state dict: `<name>.weight` OIHW and `<name>.bias`, f32 (fp16 with
    `half`), on the CPU. Depth heads are written the same way."""

    def t(x):
        out = x.detach().to("cpu", torch.float32).contiguous().clone()
        return out.half() if half else out

    sd = {}
    for name, p in params.items():
        sd[name + ".weight"] = t(p["w"])
        sd[name + ".bias"] = t(p["b"])
    return sd


def save_encoder(path: str | Path, params: dict, half: bool = False) -> None:
    torch.save(export_encoder_state_dict(params, half=half), str(path))


def params_from_jax(encoder_np: dict | None, head_np: dict | None, device="cpu", posenet_np: dict | None = None,
                    depth_np: dict | None = None):
    """The JAX package's parameter trees (numpy arrays) in the port's layout:
    HWIO convs become OIHW, dense layers stay (cin, cout). Any tree may be
    None; `head_np` may be a stack of heads (every leaf with a leading
    scene axis, `mean` (S, 3)). Returns (encoder_params, head_params), then
    posenet_params when `posenet_np` is given, then depth-head params when
    `depth_np` is given."""

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    def convs(tree):
        return _to({name: {"w": t(np.asarray(p["w"]).transpose(3, 2, 0, 1)), "b": t(p["b"])}
                    for name, p in tree.items()}, device)

    enc = None if encoder_np is None else convs(encoder_np)
    head = None
    if head_np is not None:
        head = {"blocks": []}
        for key, p in head_np.items():
            if key == "blocks":
                head["blocks"] = [
                    {c: {"w": t(q["w"]), "b": t(q["b"])} for c, q in blk.items()} for blk in p
                ]
            elif key == "mean":
                # (3,), or (S, 3) in a stack of per-scene heads
                head["mean"] = t(p) if np.ndim(p) == 2 else t(p).reshape(3)
            else:
                head[key] = {"w": t(p["w"]), "b": t(p["b"])}
        head = _to(head, device)
    out = [enc, head]
    if posenet_np is not None:
        out.append(_to({k: {"w": t(p["w"]), "b": t(p["b"])} for k, p in posenet_np.items()}, device))
    if depth_np is not None:
        out.append(convs(depth_np))
    return tuple(out)
