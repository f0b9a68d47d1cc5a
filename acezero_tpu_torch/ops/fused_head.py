"""Fused scene-coordinate head chain (forward): CUDA kernel and plain version.

The head's 512-wide residual chain (res3 block, extra blocks, fc1, fc2) is
one (L, C, C) weight stack plus a tag per layer saying where a residual add
follows, so one kernel serves any `num_head_blocks`. `fused_head_chain`
launches the Hopper kernel in `csrc/fused_head_fwd.cu` for CUDA tensors and
runs `fused_head_chain_plain` only for CPU tensors; there is no fallback
from one to the other. fc3 and the homogeneous epilogue stay outside
(`models/head.py`).
"""

from __future__ import annotations

import ctypes

import torch

from acezero_tpu_torch.models.head import HeadConfig
from acezero_tpu_torch.ops import build

KERNEL = "fused_head_fwd"
CHANNELS = 512

# Kernel launches made by `fused_head_chain` in this process.
LAUNCHES = 0


def head_params_to_stack(params: dict, cfg: HeadConfig):
    """Stack the 512x512 chain into (L, C, C) bf16 weights / (L, C) f32 biases.

    Returns (w_stack, b_stack, res_after): `res_after[l]` is 1 where a
    residual add happens after layer l (the end of res3 and of each extra
    block; fc1/fc2 have none).
    """
    chain = [params["res3_conv1"], params["res3_conv2"], params["res3_conv3"]]
    for block in params["blocks"]:
        chain += [block["c0"], block["c1"], block["c2"]]
    chain += [params["fc1"], params["fc2"]]

    w = torch.stack([c["w"] for c in chain]).to(torch.bfloat16).contiguous()
    b = torch.stack([c["b"] for c in chain]).to(torch.float32).contiguous()
    res_after = [0] * len(chain)
    for k in range(1 + cfg.num_head_blocks):
        res_after[3 * k + 2] = 1
    return w, b, tuple(res_after)


def fused_head_chain_plain(x, w_stack, b_stack, res_after):
    """The chain in plain PyTorch: f32 accumulation, bf16 activations.

    bf16 products are exact in f32, so `h.float() @ W.float()` (TF32 off) is
    the kernel's f32-accumulated bf16 product up to summation order.
    """
    res = x
    h = x
    for l, is_res in enumerate(res_after):
        pre = torch.matmul(h.float(), w_stack[l].float()) + b_stack[l]
        a = torch.relu(pre).to(torch.bfloat16)
        if is_res:
            res = res + a
            h = res
        else:
            h = a
    return h


def _check(x, w_stack, b_stack, res_after):
    if x.dim() != 2 or x.shape[1] != CHANNELS:
        raise ValueError(f"x must be (B, {CHANNELS}), got {tuple(x.shape)}")
    L = len(res_after)
    if tuple(w_stack.shape) != (L, CHANNELS, CHANNELS) or tuple(b_stack.shape) != (L, CHANNELS):
        raise ValueError(
            f"w_stack {tuple(w_stack.shape)} / b_stack {tuple(b_stack.shape)} do not "
            f"match {L} layers of width {CHANNELS}"
        )
    for name, t, dtype in (("x", x, torch.bfloat16), ("w_stack", w_stack, torch.bfloat16),
                           ("b_stack", b_stack, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _launcher():
    """The kernel's C launcher, built and loaded on first use:
    (x, w, b, res_after[L], out, B, L, stream) -> cudaError_t."""
    fn = build.load(KERNEL).fused_head_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def fused_head_chain(x, w_stack, b_stack, res_after):
    """(B, 512) bf16 -> (B, 512) bf16 through the L-layer residual chain.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.
    """
    _check(x, w_stack, b_stack, res_after)
    if x.device.type == "cpu":
        return fused_head_chain_plain(x, w_stack, b_stack, res_after)
    if x.device.type != "cuda":
        raise ValueError(f"fused_head_chain runs on cuda or cpu, not {x.device}")
    for name, t in (("x", x), ("w_stack", w_stack), ("b_stack", b_stack)):
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name} must be contiguous and 32-byte aligned")
    fn = _launcher()
    out = torch.empty_like(x)
    L = len(res_after)
    tags = (ctypes.c_int * L)(*[int(bool(t)) for t in res_after])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w_stack.data_ptr(), b_stack.data_ptr(), tags,
                out.data_ptr(), x.shape[0], L, stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out
