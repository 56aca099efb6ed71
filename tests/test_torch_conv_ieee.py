"""The port's IEEE-f32 convolution (`models/_layers.py::conv_ieee`, the
route of every f32 convolution on the card) on the CPU: `_hold_ieee` turns
cuDNN's TF32 flag off around a convolution's backward node and, under
`create_graph`, around its double-backward node (the R1 penalty's), then
restores the caller's setting; the nodes stay PyTorch's own, so results
equal PyTorch's convolution bit for bit and the engine computes only the
gradients a backward asks for. On the CPU `conv_ieee` takes PyTorch's op
alone, so the hooks are applied directly here; that TF32 stays off on the
card is held by `tests/test_torch_cuda_kernels.py`.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from muse_maskgit_pytorch_tpu_torch.models import _layers


def _case(transposed, seed=0):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(2, 3, 7, 6).astype(np.float32))
    w = torch.from_numpy(rs.randn(*((3, 4, 4, 4) if transposed else (4, 3, 3, 3))).astype(np.float32))
    b = torch.from_numpy(rs.randn(4).astype(np.float32))
    conf = ([2, 2], [1, 1], transposed, [0, 0])
    return x, w, b, conf


def _native(x, w, b, conf):
    stride, padding, transposed, _ = conf
    if transposed:
        return F.conv_transpose2d(x, w, b, stride, padding)
    return F.conv2d(x, w, b, stride, padding)


def _ieee(x, w, b, conf, seen=None):
    # conv_ieee's card route: the forward with TF32 off, the node held
    stride, padding, transposed, output_padding = conf
    with _layers._cudnn_ieee():
        y = torch.ops.aten.convolution(x, w, b, stride, padding, [1, 1], transposed, output_padding, 1)
    _layers._hold_ieee(y.grad_fn)
    if seen is not None:  # registered after `_hold_ieee`'s, so it runs inside them
        y.grad_fn.register_prehook(lambda _: seen.append(torch.backends.cudnn.allow_tf32))
    return y


@pytest.fixture
def tf32_on():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32 = saved


def _run(fn, x, w, b, conf, with_bias, seen=None):
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = fn(leaves[0], leaves[1], leaves[2] if with_bias else None, conf, *([seen] if seen is not None else []))
    gy = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
    grads = torch.autograd.grad(y, leaves[: 2 + with_bias], gy, create_graph=True)
    if seen is not None:
        assert grads[0].grad_fn.name().startswith("ConvolutionBackwardBackward")
        grads[0].grad_fn.register_prehook(lambda _: seen.append(torch.backends.cudnn.allow_tf32))
    # the R1 penalty's form: the squared norm of the input gradient, differentiated
    second = torch.autograd.grad((grads[0] ** 2).sum() + (grads[1] ** 2).sum(), leaves[:2])
    return [y.detach(), *(g.detach() for g in grads), *second]


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "transposed"])
def test_conv_ieee_matches_torch(transposed, with_bias, tf32_on):
    x, w, b, conf = _case(transposed)
    seen = []
    got = _run(_ieee, x, w, b, conf, with_bias, seen)
    # the backward and the double backward each ran with TF32 off, and the
    # caller's setting is back
    assert seen == [False, False]
    assert torch.backends.cudnn.allow_tf32 and _layers._tf32_users == 0
    want = _run(_native, x, w, b, conf, with_bias)
    assert len(got) == len(want)
    for i, (a, c) in enumerate(zip(got, want)):
        assert torch.equal(a, c), i


class _BackwardMasks(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.masks = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution_backward.default:
            self.masks.append(list(args[-1]))
        return func(*args, **(kwargs or {}))


def test_conv_ieee_skips_unneeded_gradients(tf32_on):
    # x needs a gradient too, but this backward asks for w's only: the held
    # node computes w's alone, as PyTorch's does
    x, w, b, conf = _case(False, seed=1)
    x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = _ieee(x, w, b, conf)
    with _BackwardMasks() as spy:
        (gw,) = torch.autograd.grad(y.sum(), [w])
    assert spy.masks == [[False, True, False]]
    (want,) = torch.autograd.grad(_native(x, w, b, conf).sum(), [w])
    assert torch.equal(gw, want)
    assert torch.backends.cudnn.allow_tf32 and _layers._tf32_users == 0


def test_layers_route_f32_through_conv_ieee_only_on_the_card(monkeypatch):
    # on the CPU the layers call PyTorch's op; the hooks are the card's route
    calls = []
    monkeypatch.setattr(_layers, "_hold_ieee", lambda node: calls.append(node))
    conv = _layers.Conv2d(3, 4, 3, padding=1, generator=torch.Generator().manual_seed(0))
    up = _layers.ConvTranspose2d(4, 2, generator=torch.Generator().manual_seed(1))
    x = torch.randn(1, 3, 8, 8, generator=torch.Generator().manual_seed(2))
    y = up(conv(x))
    assert y.shape == (1, 2, 16, 16) and y.grad_fn is not None and calls == []
    want = F.conv_transpose2d(F.conv2d(x, conv.weight, conv.bias, 1, 1), up.weight, up.bias, 2, 1)
    assert torch.equal(y, want)
