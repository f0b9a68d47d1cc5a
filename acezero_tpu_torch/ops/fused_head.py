"""Fused scene-coordinate head chain: CUDA kernels, plain versions and VJP.

The head's 512-wide residual chain (res3 block, extra blocks, fc1, fc2) is
one (L, C, C) weight stack plus a tag per layer saying where a residual add
follows, so one kernel serves any `num_head_blocks`. `fused_head_chain`
launches the forward kernel `csrc/fused_head_fwd.cu` and
`fused_head_chain_backward` the recompute-based backward kernel
`csrc/fused_head_bwd.cu` for CUDA tensors; both run their plain versions
only for CPU tensors, and there is no fallback from one to the other.
`FusedHeadChain` is the autograd Function around them (the counterpart of
the JAX package's custom VJP `fused_head_mlp`). fc3 and the homogeneous
epilogue stay outside (`models/head.py`).
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from acezero_tpu_torch.models.head import HeadConfig
from acezero_tpu_torch.ops import build

KERNEL = "fused_head_fwd"
KERNEL_BWD = "fused_head_bwd"
CHANNELS = 512
TILE_ROWS = 64  # rows of x per tile of either kernel

# Kernel launches made by `fused_head_chain` / `fused_head_chain_backward`
# in this process, in all and by CUDA device index.
LAUNCHES = 0
LAUNCHES_BWD = 0
LAUNCHES_BY_DEVICE: Counter = Counter()
LAUNCHES_BWD_BY_DEVICE: Counter = Counter()


def _chain_layers(params: dict) -> list:
    chain = [params["res3_conv1"], params["res3_conv2"], params["res3_conv3"]]
    for block in params["blocks"]:
        chain += [block["c0"], block["c1"], block["c2"]]
    return chain + [params["fc1"], params["fc2"]]


def head_params_to_stack(params: dict, cfg: HeadConfig, w_dtype=torch.bfloat16):
    """Stack the 512x512 chain into (L, C, C) weights / (L, C) f32 biases.

    Returns (w_stack, b_stack, res_after): `res_after[l]` is 1 where a
    residual add happens after layer l (the end of res3 and of each extra
    block; fc1/fc2 have none). The weights are bf16, the kernels' type, by
    default; training passes `w_dtype=torch.float32` so that the weight
    gradient reaches the f32 parameters unrounded (`FusedHeadChain` rounds
    the weights to bf16 itself). The stack is differentiable.
    """
    chain = _chain_layers(params)
    w = torch.stack([c["w"] for c in chain]).to(w_dtype).contiguous()
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
    LAUNCHES_BY_DEVICE[x.device.index] += 1
    return out


def stack_to_head_grads(params: dict, cfg: HeadConfig, dw, db) -> dict:
    """Scatter stacked (L, C, C) / (L, C) grads back into the head's layout,
    in `_chain_layers` order: zeros for fc3, `mean` and any leaf outside the
    chain."""
    grads = {k: {"w": torch.zeros_like(v["w"]), "b": torch.zeros_like(v["b"])} if isinstance(v, dict)
             else torch.zeros_like(v) for k, v in params.items() if k != "blocks"}
    grads["blocks"] = [{} for _ in range(cfg.num_head_blocks)]
    slots = [(grads, "res3_conv1"), (grads, "res3_conv2"), (grads, "res3_conv3")]
    slots += [(block, f"c{j}") for block in grads["blocks"] for j in range(3)]
    slots += [(grads, "fc1"), (grads, "fc2")]
    for l, (tree, key) in enumerate(slots):
        tree[key] = {"w": dw[l], "b": db[l]}
    return grads


def fused_head_chain_backward_plain(x, w_stack, b_stack, g, res_after):
    """The backward kernel's function in plain PyTorch, with its rounding
    points: rerun the chain recording each layer's bf16 input and the ReLU
    mask of its f32 pre-activation, then walk back. Returns (dx, gpre,
    acts_in): dx (B, C) bf16, gpre and acts_in (L, B, C) bf16."""
    acts_in, masks = [], []
    res = h = x
    for l, is_res in enumerate(res_after):
        acts_in.append(h)
        pre = torch.matmul(h.float(), w_stack[l].float()) + b_stack[l]
        masks.append(pre > 0)
        a = torch.relu(pre).to(torch.bfloat16)
        if is_res:
            res = res + a
            h = res
        else:
            h = a
    g = g.to(torch.bfloat16)
    g_res = torch.zeros_like(g)
    gpre = [None] * len(res_after)
    for l in reversed(range(len(res_after))):
        if res_after[l]:
            g = g + g_res
            g_res = g
        gpre[l] = torch.where(masks[l], g, torch.zeros_like(g))
        g = torch.matmul(gpre[l].float(), w_stack[l].float().t()).to(torch.bfloat16)
    return g + g_res, torch.stack(gpre), torch.stack(acts_in)


def _launcher_bwd():
    """The backward kernel's C launcher, built and loaded on first use:
    (x, w, b, g, res_after[L], dx, gpre, acts_in, masks, B, L, stream) -> cudaError_t."""
    fn = build.load(KERNEL_BWD).fused_head_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def fused_head_chain_backward(x, w_stack, b_stack, g, res_after):
    """(dx, gpre, acts_in) of the chain at x for the output gradient g
    (B, 512) bf16. CUDA tensors launch the kernel (or raise); CPU tensors
    take the plain version."""
    _check(x, w_stack, b_stack, res_after)
    if g.shape != x.shape or g.dtype != torch.bfloat16 or g.device != x.device:
        raise ValueError(f"g must be a {tuple(x.shape)} bf16 tensor on {x.device}")
    if x.device.type == "cpu":
        return fused_head_chain_backward_plain(x, w_stack, b_stack, g, res_after)
    if x.device.type != "cuda":
        raise ValueError(f"fused_head_chain_backward runs on cuda or cpu, not {x.device}")
    for name, t in (("x", x), ("w_stack", w_stack), ("b_stack", b_stack), ("g", g)):
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name} must be contiguous and 32-byte aligned")
    fn = _launcher_bwd()
    B, L = x.shape[0], len(res_after)
    dx = torch.empty_like(x)
    gpre = torch.empty((L, B, CHANNELS), dtype=torch.bfloat16, device=x.device)
    acts_in = torch.empty_like(gpre)
    # the kernel's private ReLU-mask scratch: 512 bits per row of each 64-row tile
    masks = torch.empty((L, -(-B // TILE_ROWS) * TILE_ROWS, CHANNELS // 8), dtype=torch.uint8, device=x.device)
    tags = (ctypes.c_int * L)(*[int(bool(t)) for t in res_after])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w_stack.data_ptr(), b_stack.data_ptr(), g.data_ptr(), tags,
                dx.data_ptr(), gpre.data_ptr(), acts_in.data_ptr(), masks.data_ptr(), B, L, stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL_BWD} launch failed: CUDA error {rc}")
    global LAUNCHES_BWD
    LAUNCHES_BWD += 1
    LAUNCHES_BWD_BY_DEVICE[x.device.index] += 1
    return dx, gpre, acts_in


def _kernel_info(name: str) -> dict:
    fn = getattr(build.load(name), f"{name}_info")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    info = (ctypes.c_int * 5)()
    rc = fn(info)
    if rc != 0:
        raise RuntimeError(f"{name}_info failed: CUDA error {rc}")
    return dict(zip(("smem_bytes", "threads", "tile_rows", "registers", "local_bytes"), info))


def forward_kernel_info() -> dict:
    """The forward kernel's resources as the card reports them (builds the
    kernel on first use): dynamic shared bytes, threads, rows per tile,
    registers and local (stack and spill) bytes per thread."""
    return _kernel_info(KERNEL)


def backward_kernel_info() -> dict:
    """The backward kernel's resources, as `forward_kernel_info`."""
    return _kernel_info(KERNEL_BWD)


def chain_weight_grads(gpre, acts_in):
    """dW = einsum('lbc,lbd->lcd', acts_in, gpre) and db = sum_b gpre, both
    accumulated in f32 from the bf16 stacks without rounding the products:
    one batched GEMM with f32 output on the card (cuBLAS), an f32 GEMM of the
    exactly widened operands on the CPU. Outside the kernel, as in JAX."""
    db = gpre.float().sum(dim=1)
    if gpre.device.type == "cuda":
        dw = torch.bmm(acts_in.transpose(1, 2), gpre, out_dtype=torch.float32)
    else:
        dw = torch.bmm(acts_in.float().transpose(1, 2), gpre.float())
    return dw, db


class FusedHeadChain(torch.autograd.Function):
    """The chain with a recompute-based backward: the counterpart of the JAX
    package's `fused_head_mlp` custom VJP. The forward saves only its inputs;
    the backward reruns the chain in `fused_head_chain_backward` and forms
    dW, db outside the kernel. `w_stack` may be f32 (the gradient then stays
    f32) or bf16; the kernels see it rounded to bf16."""

    @staticmethod
    def forward(ctx, x, w_stack, b_stack, res_after):
        w_bf = w_stack.detach().to(torch.bfloat16).contiguous()
        b = b_stack.detach().float().contiguous()
        ctx.res_after = tuple(res_after)
        ctx.save_for_backward(x, w_bf, b)
        return fused_head_chain(x.detach().contiguous(), w_bf, b, ctx.res_after)

    @staticmethod
    def backward(ctx, g):
        x, w_bf, b = ctx.saved_tensors
        dx, gpre, acts_in = fused_head_chain_backward(
            x.contiguous(), w_bf, b, g.to(torch.bfloat16).contiguous(), ctx.res_after)
        dw, db = chain_weight_grads(gpre, acts_in)
        return dx, dw, db, None
