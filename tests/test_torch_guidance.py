"""Port parity for the guidance forms of `MaskGit.generate`: a `(start, end)`
ramp, a scalar, (T,) or (T or 1, b) tensor scale, against the JAX package
with bridged weights and injected noise (f32, toy size): token grids must be
identical. The ramp's f32 values are pinned against the jitted
`jnp.linspace`, and the decode loop must read no scale on the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muse_maskgit_pytorch_tpu_torch.models.transformer import Transformer
from muse_maskgit_pytorch_tpu_torch.ops import sampling_kernel
from muse_maskgit_pytorch_tpu_torch.utils.sampling import guidance_ramp
from tests.torch_surface_pairs import B, T, build_pair, generate_both, gumbel, text_inputs


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def inputs():
    rs, te, mask = text_inputs(0)
    return te, mask, gumbel(rs, 16)


def test_guidance_ramp_matches_jitted_linspace():
    rs = np.random.RandomState(0)
    pairs = [(1.0, 5.0), (0.5, 7.3), (3.0, 3.0), (2.2, 1.1)] + [tuple(rs.uniform(0, 12, 2)) for _ in range(2)]
    for steps in (1, 2, 7, 8, 18, 32):
        for start, end in pairs:
            want = np.asarray(jax.jit(lambda: jnp.linspace(start, end, steps))())
            np.testing.assert_array_equal(guidance_ramp(start, end, steps), want, err_msg=f"{start} {end} {steps}")
    # the form torch.linspace takes is not it
    got = torch.linspace(1.0, 5.0, 8).numpy()
    assert not np.array_equal(got, guidance_ramp(1.0, 5.0, 8))


PER_ROW = np.array([[2.0, 4.5]], np.float32)
FORMS = {
    # (cond_scale, sampler, cfg_fold, compact)
    "ramp-fused-cfg_pair": ((1.0, 5.0), "fused", False, False),
    "ramp-xla-logits": ((1.0, 5.0), "xla", False, False),
    "ramp-xla-fold": ((0.5, 4.0), "xla", True, False),
    "scalar_tensor-fused-cfg_pair": (np.float32(2.5), "fused", False, False),
    "per_step-xla-fold": (np.linspace(4.0, 1.0, T).astype(np.float32), "xla", True, False),
    "per_row-fused-fold": (PER_ROW, "fused", True, "auto"),
    "per_step_row-xla-fold": (np.stack([PER_ROW[0] + i for i in range(T)]).astype(np.float32), "xla", True, False),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_guidance_forms_match_jax(pair, inputs, form):
    cond_scale, sampler, cfg_fold, compact = FORMS[form]
    want, got = generate_both(
        *pair, *inputs, cond_scale=cond_scale, sampler=sampler, cfg_fold=cfg_fold, compact=compact
    )
    assert got.shape == (B, 4, 4)
    np.testing.assert_array_equal(got, want)


ONE_VALUE = {
    "float": 3.0,
    "ramp": (3.0, 3.0),
    "scalar_tensor": torch.tensor(3.0),
    "numpy_scalar": np.float32(3.0),
    "per_step": torch.full((T,), 3.0),
    "per_row": torch.full((1, B), 3.0),
    "per_step_row": torch.full((T, B), 3.0),
}


@pytest.mark.parametrize("sampler", ["xla", "fused"])
def test_every_form_at_one_value_is_the_float(pair, inputs, sampler):
    # the float's grids are JAX's (tests/test_torch_generate.py); every
    # other form at 3.0 must give them token for token
    _, pm = pair
    te, mask, noise = inputs
    want = None
    for name, cond_scale in ONE_VALUE.items():
        got = pm.generate(
            text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask), timesteps=T, sampler=sampler,
            injected_gumbel_noise=torch.from_numpy(noise), cond_scale=cond_scale, return_ids=True,
        )
        want = got if want is None else want
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=name)


class _HostReads(torch.overrides.TorchFunctionMode):
    """Counts the reads of a tensor's value by the host."""

    NAMES = ("item", "tolist", "__bool__", "__float__", "__int__", "__index__", "numpy")

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.NAMES:
            self.reads.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("cfg_fold", [True, False], ids=["fold", "cfg_pair"])
def test_the_loop_reads_no_scale_on_the_host(pair, inputs, cfg_fold, monkeypatch, capsys):
    _, pm = pair
    te, mask, noise = inputs
    seen = []
    kernel = sampling_kernel.fused_topk_gumbel_sample

    def spy(*args, **kw):
        seen.append(kw["cond_scale"])
        return kernel(*args, **kw)

    monkeypatch.setattr("muse_maskgit_pytorch_tpu_torch.models.maskgit.fused_topk_gumbel_sample", spy)
    kw = dict(
        text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask), timesteps=T, sampler="fused",
        injected_gumbel_noise=torch.from_numpy(noise), return_ids=True, cfg_fold=cfg_fold,
    )
    with _HostReads() as mode:
        pm.generate(cond_scale=(1.0, 5.0), progress=True, **kw)
    # the progress lines come from the loop's own counter, not the device
    assert mode.reads == []
    assert capsys.readouterr().out.splitlines() == [f"maskgit decode step {i}/{T}" for i in range(1, T + 1)]
    if not cfg_fold:
        # K1's cfg_pair route gets each step's scale as a one-element tensor
        assert all(isinstance(s, torch.Tensor) and s.shape == (1,) for s in seen)
        assert [float(s) for s in seen] == guidance_ramp(1.0, 5.0, T).tolist()


def test_forward_with_cond_scale_takes_tensors(pair):
    _, pm = pair
    tr: Transformer = pm.transformer
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randint(0, 64, (B, 16)))
    te = torch.from_numpy(rs.randn(B, 6, 24).astype(np.float32))
    with torch.no_grad():
        for fold in (True, False):
            ref = tr.forward_with_cond_scale(x, text_embeds=te, cond_scale=2.0, cfg_fold=fold)
            zero_d = tr.forward_with_cond_scale(x, text_embeds=te, cond_scale=torch.tensor(2.0), cfg_fold=fold)
            assert torch.equal(ref, zero_d)
        rows = tr.forward_with_cond_scale(x, text_embeds=te, cond_scale=torch.tensor([2.0, 5.0]))
        for i, s in enumerate((2.0, 5.0)):
            one = tr.forward_with_cond_scale(x[i : i + 1], text_embeds=te[i : i + 1], cond_scale=s)
            torch.testing.assert_close(rows[i : i + 1], one, atol=1e-5, rtol=1e-5)
        # a tensor equal to 1 still runs the doubled batch; the float 1 runs one pass
        single = tr.forward_with_cond_scale(x, text_embeds=te, cond_scale=1.0)
        doubled = tr.forward_with_cond_scale(x, text_embeds=te, cond_scale=torch.tensor(1.0))
        torch.testing.assert_close(single, doubled, atol=1e-5, rtol=1e-5)
        embed = tr.forward_with_cond_scale(x, text_embeds=te, cond_scale=torch.tensor(3.0), return_embed_only=True)
        _, want = tr(x, text_embeds=te, return_embed=True)
        assert embed.shape == (B, 16, 32)
        torch.testing.assert_close(embed, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "cond_scale, cfg_fold, match",
    [
        (np.full((1, B), 2.0, np.float32), False, "requires cfg_fold"),
        (np.full((1, B + 1), 2.0, np.float32), True, "columns"),
        (np.full((T, B, 1), 2.0, np.float32), True, "scalar"),
    ],
    ids=["per_row_without_fold", "wrong_columns", "three_dims"],
)
def test_bad_scales_raise(pair, inputs, cond_scale, cfg_fold, match):
    _, pm = pair
    te, _, _ = inputs
    with pytest.raises(ValueError, match=match):
        pm.generate(text_embeds=torch.from_numpy(te), timesteps=T, cond_scale=cond_scale, cfg_fold=cfg_fold)
