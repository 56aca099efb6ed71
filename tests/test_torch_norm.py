"""The trunk's normalisation operators (`ops/norm.py`) on the CPU.

`muse_torch::layer_norm` and `muse_torch::geglu_layer_norm` run their
plain versions on CPU tensors, which must be the models' composite code bit
for bit (so the parity tests against the JAX package see the numbers they
saw before the operators); their fake implementations give `torch.export`
the right shapes and dtypes; a module takes the composite route under
autograd, with the gradients it had, and the operators where no gradient is
recorded, as its counters and the operators' calls show. The kernels
themselves are held to these plain versions on the card
(`tests/test_torch_cuda_kernels.py`).
"""

import contextlib

import pytest
import torch
import torch.nn.functional as F

from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer
from muse_maskgit_pytorch_tpu_torch.models import transformer as pt
from muse_maskgit_pytorch_tpu_torch.models.maskgit import TrainDraws
from muse_maskgit_pytorch_tpu_torch.ops import norm

DTYPES = [torch.float32, torch.bfloat16]
WIDTHS = [512, 1365, 7]
DEPTH = 2


def _composite_layer_norm(x, gamma):
    # `LayerNorm.forward` as the models wrote it before the operator
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    normed = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return (normed * gamma).to(x.dtype)


def _composite_geglu_layer_norm(h, gamma):
    # the unsplit `FeedForward.forward` between `proj_in` and `proj_out`
    x, gate = h.chunk(2, dim=-1)
    x = gate * F.gelu(x)
    return _composite_layer_norm(x, gamma)


def _inputs(d, dtype, geglu, seed=0):
    g = torch.Generator().manual_seed(seed + d)
    x = (torch.randn(3, 37, 2 * d if geglu else d, generator=g) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(d, generator=g)
    return x, gamma


@pytest.mark.parametrize("geglu", [False, True], ids=["layer_norm", "geglu_layer_norm"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_cpu_operator_is_the_composite_code(d, dtype, geglu):
    x, gamma = _inputs(d, dtype, geglu)
    op = torch.ops.muse_torch.geglu_layer_norm if geglu else torch.ops.muse_torch.layer_norm
    composite = _composite_geglu_layer_norm if geglu else _composite_layer_norm
    got = op(x, gamma)
    assert got.dtype == dtype and got.shape == (3, 37, d)
    assert torch.equal(got, composite(x, gamma))
    # a strided row input (every other row)
    assert torch.equal(op(x[:, ::2], gamma), composite(x[:, ::2], gamma))


class _Both(torch.nn.Module):
    def forward(self, x, h, gamma):
        return torch.ops.muse_torch.layer_norm(x, gamma), torch.ops.muse_torch.geglu_layer_norm(h, gamma)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_fake_implementations_under_export(dtype):
    d = 7
    x, gamma = _inputs(d, dtype, geglu=False)
    h, _ = _inputs(d, dtype, geglu=True)
    ep = torch.export.export(_Both(), (x, h, gamma), strict=False)
    vals = {str(n.target): n.meta["val"] for n in ep.graph.nodes if n.op == "call_function"}
    for name, shape in (("muse_torch.layer_norm.default", x.shape), ("muse_torch.geglu_layer_norm.default", x.shape)):
        assert vals[name].shape == shape and vals[name].dtype == dtype
    out = ep.module()(x, h, gamma)
    assert torch.equal(out[0], _composite_layer_norm(x, gamma))
    assert torch.equal(out[1], _composite_geglu_layer_norm(h, gamma))


@contextlib.contextmanager
def _counted_ops(monkeypatch):
    """Count the operator calls the wrappers make (on the CPU no kernel
    launches, so `.launches` stays put)."""
    calls = {"layer_norm": 0, "geglu_layer_norm": 0}

    def counting(name, op):
        def call(*args):
            calls[name] += 1
            return op(*args)

        return call

    monkeypatch.setattr(norm, "_layer_norm_op", counting("layer_norm", norm._layer_norm_op))
    monkeypatch.setattr(norm, "_geglu_op", counting("geglu_layer_norm", norm._geglu_op))
    before = norm.layer_norm.composite, norm.geglu_layer_norm.composite
    counts = {"ops": calls}
    yield counts
    counts["composite"] = (
        norm.layer_norm.composite - before[0],
        norm.geglu_layer_norm.composite - before[1],
    )


def _ff_pair(dtype):
    ff = pt.FeedForward(64, dtype=dtype, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for ln in (ff.norm, ff.norm_inner):
            ln.gamma.copy_(1 + 0.1 * torch.randn(ln.gamma.shape, generator=torch.Generator().manual_seed(2)))
    return ff


def _ff_composite(ff, x):
    h = ff.proj_in(_composite_layer_norm(x, ff.norm.gamma))
    return ff.proj_out(_composite_geglu_layer_norm(h, ff.norm_inner.gamma))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_autograd_takes_the_composite_route_with_todays_gradients(dtype, monkeypatch):
    ff = _ff_pair(dtype)
    x = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(3)).to(dtype).requires_grad_()
    with _counted_ops(monkeypatch) as counts:
        out = ff(x)
    assert counts["ops"] == {"layer_norm": 0, "geglu_layer_norm": 0} and counts["composite"] == (1, 1)
    grads = torch.autograd.grad(out.float().square().sum(), [x, *ff.parameters()])
    ref_out = _ff_composite(ff, x)
    ref = torch.autograd.grad(ref_out.float().square().sum(), [x, *ff.parameters()])
    assert torch.equal(out, ref_out)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "frozen"])
def test_no_gradient_recorded_calls_the_operators(mode, monkeypatch):
    # `frozen`: gradients on, but no input needs one
    tr = MaskGitTransformer(
        num_tokens=64, dim=32, seq_len=16, depth=DEPTH, dim_head=16, heads=2, text_embed_dim=24, self_cond=True,
        device="cpu", generator=torch.Generator().manual_seed(0),
    )
    ids = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(4))
    te = torch.randn(2, 5, 24, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = tr(ids, text_embeds=te)
    if mode == "frozen":
        tr.requires_grad_(False)
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode, "frozen": contextlib.nullcontext}[mode]
    with _counted_ops(monkeypatch) as counts, ctx():
        got = tr(ids, text_embeds=te)
    # a block's three LayerNorms and its GEGLU, the final norm, and the
    # self-conditioning FeedForward's LayerNorm and GEGLU
    assert counts["ops"] == {"layer_norm": 3 * DEPTH + 1 + 1, "geglu_layer_norm": DEPTH + 1}
    assert counts["composite"] == (0, 0)
    assert torch.equal(got, want)


def test_train_step_norms_composite_but_the_self_conditioning_pass(monkeypatch):
    tr = MaskGitTransformer(
        num_tokens=64, dim=32, seq_len=16, depth=DEPTH, dim_head=16, heads=2, text_embed_dim=24, self_cond=True,
        device="cpu", generator=torch.Generator().manual_seed(0),
    )
    model = MaskGit(image_size=16, transformer=tr, vae=None, self_cond_prob=1.0, device="cpu")
    ids = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(6))
    te = torch.randn(2, 5, 24, generator=torch.Generator().manual_seed(7))
    draws = TrainDraws.draw(2, 16, 64, critic=False, generator=torch.Generator().manual_seed(8))
    with _counted_ops(monkeypatch) as counts:
        loss = model(ids, text_embeds=te, draws=draws)
    loss.backward()
    per_pass = (3 * DEPTH + 1 + 1, DEPTH + 1)
    assert counts["ops"] == dict(zip(("layer_norm", "geglu_layer_norm"), per_pass))  # the self-conditioning pass
    assert counts["composite"] == per_pass  # the pass with a gradient
    assert all(p.grad is not None for p in (tr.transformer_blocks.norm.gamma, tr.self_cond_to_init_embed.norm_inner.gamma))
