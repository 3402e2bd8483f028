"""Small residual CNN classifier (the port of ``repro.models.cnn``): the
stand-in for ResNet-18 on CIFAR-10 in the paper's §4.2 experiment (no
dataset is in the repository). Three residual stages over 16x16x3
synthetic images, plain functions on a parameter dict.

Layouts: images are NHWC, as in the reference (``data.image_dataset``);
convolution weights are PyTorch's OIHW (the reference's are HWIO;
``convert`` carries them across and defines the flat J-vector in the
reference's order). The convolutions are ``F.conv2d``, as the reference
leaves its own to XLA outside any Pallas kernel. XLA's "SAME" padding
puts the odd pixel after: a 3x3 stride-2 convolution from 16 to 8 pads 0
before and 1 after, which ``_same`` pads explicitly. cuDNN computes fp32
convolutions in TF32 by default; :func:`fp32_convolutions` turns that
off for the block it guards and restores the caller's setting after.
``_same`` runs every forward convolution under it, so ``cnn_fwd`` and
``cnn_loss`` convolve in fp32 as the reference does; the backward
convolutions run when autograd reaches them, so a caller that
differentiates ``cnn_loss`` itself guards that call too, as
``cnn_grad`` does.

The NHWC input is made contiguous NCHW before the first convolution. On
the CPU (torch 2.13, oneDNN 3.12, 8 threads), the channels-last view
that the permute alone gives made the gradients differ from run to run
by up to 6e-3 on the same inputs; PyTorch's native convolution, the
alternative, is off by up to 4e-5 on outputs of magnitude 10 (oneDNN
and XLA: 2e-6).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

# (name, kernel size, in, out) in units of the width w; head_w and
# head_b follow
_CONVS = (("stem", 3, 0, 1), ("b1a", 3, 1, 1), ("b1b", 3, 1, 1),
          ("b2a", 3, 1, 2), ("b2b", 3, 2, 2), ("b2s", 1, 1, 2),
          ("b3a", 3, 2, 4), ("b3b", 3, 4, 4), ("b3s", 1, 2, 4))


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN convolutions in full fp32 (no TF32) inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def init_cnn(gen: torch.Generator, n_classes=10, width=32,
             device="cpu") -> dict:
    """Parameters drawn from ``gen``: each convolution N(0, 1/fan_in)
    (fan_in = kh * kw * c_in), the head N(0, 1/(4w)), the bias zero.
    The reference draws from its own PRNG: the tests carry its
    parameters across (``convert.cnn_params_from_jax``)."""
    w = width
    p = {}
    for name, k, cin, cout in _CONVS:
        cin = 3 if cin == 0 else cin * w
        p[name] = torch.randn((cout * w, cin, k, k), generator=gen,
                              device=device) * (k * k * cin) ** -0.5
    p["head_w"] = torch.randn((4 * w, n_classes), generator=gen,
                              device=device) * (4 * w) ** -0.5
    p["head_b"] = torch.zeros(n_classes, device=device)
    return p


def _same(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """XLA's "SAME" convolution of NCHW x by OIHW w: the output is
    ceil(in / stride), the padding split with the odd pixel after."""
    k, size = w.shape[-1], x.shape[-1]
    out = -(-size // stride)
    pad = max((out - 1) * stride + k - size, 0)
    x = F.pad(x, (pad // 2, pad - pad // 2, pad // 2, pad - pad // 2))
    with fp32_convolutions():
        return F.conv2d(x, w, stride=stride)


def _norm(x: torch.Tensor) -> torch.Tensor:
    # parameter-free per-sample normalization: the population std over
    # (C, H, W), with 1e-5 added to the std (jnp.std, as the reference)
    mu = x.mean(dim=(1, 2, 3), keepdim=True)
    sd = x.std(dim=(1, 2, 3), correction=0, keepdim=True) + 1e-5
    return (x - mu) / sd


def cnn_fwd(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits (B, n_classes) of NHWC images x."""
    h = x.permute(0, 3, 1, 2).contiguous()
    h = F.relu(_norm(_same(h, p["stem"])))
    r = h
    h = F.relu(_norm(_same(h, p["b1a"])))
    h = F.relu(r + _norm(_same(h, p["b1b"])))
    r = _same(h, p["b2s"], 2)
    h = F.relu(_norm(_same(h, p["b2a"], 2)))
    h = F.relu(r + _norm(_same(h, p["b2b"])))
    r = _same(h, p["b3s"], 2)
    h = F.relu(_norm(_same(h, p["b3a"], 2)))
    h = F.relu(r + _norm(_same(h, p["b3b"])))
    h = h.mean(dim=(2, 3))
    return h @ p["head_w"] + p["head_b"]


def cnn_loss(p: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the logits against int labels y."""
    logp = F.log_softmax(cnn_fwd(p, x), dim=-1)
    return -logp.gather(1, y.long().reshape(-1, 1)).mean()


def cnn_grad(p: dict, x: torch.Tensor, y: torch.Tensor) -> dict:
    """The loss's gradient by parameter (fp32 convolutions throughout:
    the guard covers the backward pass's convolutions too)."""
    leaves = {key: val.detach().requires_grad_(True)
              for key, val in p.items()}
    with fp32_convolutions():
        loss = cnn_loss(leaves, x, y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads))


@torch.no_grad()
def cnn_accuracy(p: dict, x: torch.Tensor, y: torch.Tensor,
                 batch: int = 250) -> float:
    correct = 0
    for i in range(0, x.shape[0], batch):
        logits = cnn_fwd(p, x[i:i + batch])
        correct += int((logits.argmax(-1) == y[i:i + batch]).sum())
    return correct / x.shape[0]
