"""The exact sampler (`sampler="xla"`) on K1's noise stream, on the CPU:

  * the operator `muse_torch::philox_gumbel` (`philox_gumbel_noise`): its
    CPU implementation is `philox_gumbel` rounded once to the dtype, and a
    `row_offset` slice is those rows of the whole;
  * both samplers draw the same noise: with no top-k filter (k = V) and f32
    logits, K1's plain version keyed on a seed and the exact sampler on the
    operator's noise for that seed pick the same ids;
  * `export_pipeline(sampler="xla")` of a `Muse` cascade in both hand-offs
    and of a standalone super-res stage: byte-equal to eager code, one
    operator a step in the graph and no `aten.rand` (the toys of
    tests/test_torch_export.py).
"""

import numpy as np
import pytest
import torch

from muse_maskgit_pytorch_tpu_torch import Muse, export_pipeline
from muse_maskgit_pytorch_tpu_torch.models.maskgit import child_generators
from muse_maskgit_pytorch_tpu_torch.ops import sampling_kernel as sk
from muse_maskgit_pytorch_tpu_torch.serving import _quantize_u8
from muse_maskgit_pytorch_tpu_torch.utils.sampling import gumbel_sample
from tests.test_torch_export import B, L, T, _eager, _inputs, _maskgit, _superres, _vae
from tests.torch_threads import few_threads  # noqa: F401


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_operator_is_philox_gumbel_rounded_once(dtype):
    seed = torch.tensor([987654], dtype=torch.int32)
    rows, V = 12, 1001  # V not a multiple of the four columns a Philox call gives
    whole = sk.philox_gumbel_noise(seed, rows, V, dtype=dtype)
    assert whole.dtype == dtype and whole.shape == (rows, V)
    assert torch.equal(whole, sk.philox_gumbel(987654, rows, V).to(dtype))
    assert torch.equal(whole, torch.ops.muse_torch.philox_gumbel(seed, rows, V, 0, dtype))
    part = sk.philox_gumbel_noise(seed, 7, V, row_offset=5, dtype=dtype)
    assert torch.equal(part, whole[5:])
    assert not torch.equal(sk.philox_gumbel_noise(seed + 1, rows, V, dtype=dtype), whole)
    assert sk.philox_gumbel_noise.launches == 0  # the CPU path is the plain version


def test_both_samplers_draw_the_same_noise():
    rs = np.random.RandomState(0)
    rows, V = 40, 96
    logits = torch.from_numpy(rs.randn(rows, V).astype(np.float32) * 3)
    seed = torch.tensor([31], dtype=torch.int32)
    for temp, offset in ((1.0, 0), (0.7, 13)):
        k1, _ = sk.fused_topk_gumbel_sample_plain(logits, V, temp, seed, row_offset=offset)
        noise = sk.philox_gumbel_noise(seed, rows, V, row_offset=offset)
        exact = gumbel_sample(logits, temp, noise=noise)
        assert torch.equal(exact, k1.long())


def _cascade():
    vae = _vae()
    return Muse(_maskgit(vae=vae, depth=1), _superres(vae), device="cpu")


@pytest.mark.parametrize("kind", ["cascade-pixels", "cascade-ids", "superres"])
def test_exact_sampler_exports_each_model_kind(kind):
    model = _superres(_vae(2)) if kind == "superres" else _cascade()
    cond_via = kind.partition("-")[2]
    te, tm = _inputs()
    kw = dict(text_embeds=te, text_mask=tm, timesteps=T, sampler="xla")
    if kind == "superres":
        ep = export_pipeline(model, batch_size=B, text_len=L, timesteps=T, sampler="xla")
        cond = torch.rand(B, 16, 16, 3, generator=torch.Generator().manual_seed(0))
        got = ep(model.state_dict(), te, tm, 6, cond_images=cond)
        want = _eager(model, 6, cond_images=cond, sampler="xla")
        steps = T
    else:
        ep = export_pipeline(model, batch_size=B, text_len=L, timesteps=T, sampler="xla", cond_via=cond_via)
        got = ep(model.state_dict(), te, tm, torch.Generator().manual_seed(5))
        g_base, g_sr = child_generators(torch.Generator().manual_seed(5), "cpu")
        via_ids = cond_via == "ids"
        low = model.base_maskgit.generate(generator=g_base, return_ids=via_ids, **kw)
        sr_cond = dict(cond_token_ids=low) if via_ids else dict(cond_images=low.clamp(0.0, 1.0))
        want = _quantize_u8(model.superres_maskgit.generate(generator=g_sr, **sr_cond, **kw))
        steps = 2 * T
        assert ep.meta["cond_via"] == cond_via
    assert ep.meta["sampler"] == "xla" and torch.equal(got, want)
    targets = [str(n.target) for n in ep.program.graph.nodes if n.op == "call_function"]
    assert targets.count("muse_torch.philox_gumbel.default") == steps
    assert "muse_torch.fused_topk_gumbel_sample.default" not in targets
    assert not [t for t in targets if "rand" in t]
