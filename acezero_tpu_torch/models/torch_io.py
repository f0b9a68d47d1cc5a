"""Checkpoint loading for the port.

Encoders (`weights/*.pt`) are torch state dicts of Conv2d layers, loaded as
they are (OIHW). Heads (ACE `iterationX.pt`, fp16) are 1x1-conv state dicts
whose architecture is inferred from the keys, as the reference does: the
extra-block count from `<i>c0.weight`, homogeneous output from fc3's width.
`params_from_jax` converts the JAX package's numpy parameter trees (HWIO
convs, (cin, cout) dense layers) into the port's layout.
"""

from __future__ import annotations

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


def load_head(path: str | Path, device="cpu") -> tuple[HeadConfig, dict]:
    return import_head_state_dict(load_state_dict(path), device)


def params_from_jax(encoder_np: dict | None, head_np: dict | None, device="cpu"):
    """The JAX package's parameter trees (numpy arrays) in the port's layout:
    HWIO convs become OIHW, dense layers stay (cin, cout). Either tree may be
    None. Returns (encoder_params, head_params)."""

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    enc = None
    if encoder_np is not None:
        enc = {
            name: {"w": t(np.asarray(p["w"]).transpose(3, 2, 0, 1)), "b": t(p["b"])}
            for name, p in encoder_np.items()
        }
        enc = _to(enc, device)
    head = None
    if head_np is not None:
        head = {"blocks": []}
        for key, p in head_np.items():
            if key == "blocks":
                head["blocks"] = [
                    {c: {"w": t(q["w"]), "b": t(q["b"])} for c, q in blk.items()} for blk in p
                ]
            elif key == "mean":
                head["mean"] = t(p).reshape(3)
            else:
                head[key] = {"w": t(p["w"]), "b": t(p["b"])}
        head = _to(head, device)
    return enc, head
