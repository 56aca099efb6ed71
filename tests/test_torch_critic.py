"""Port parity for critic-guided decoding and `can_remask_prev_masked`:
`TokenCritic` and `SelfCritic` (bridged weights), their scores steering each
step's remask, with negative prompts and per-row guidance, against the JAX
package under injected noise (f32, toy size): token grids must be identical.
JAX draws the critic's noise inside its jit with no hook to inject it, so
the exact comparisons run with `critic_noise_scale=0`.
"""

import warnings

import numpy as np
import pytest
import torch

from muse_maskgit_pytorch_tpu_torch import SelfCritic, TokenCritic
from tests.torch_surface_pairs import B, T, TEXT_DIM, build_pair, generate_both, gumbel, text_inputs

PAIRS = {
    "token": dict(critic="token"),
    "self": dict(critic="self"),
    "remask": dict(no_mask_token_prob=0.1),
    "remask_token": dict(critic="token", no_mask_token_prob=0.1),
}


@pytest.fixture(scope="module")
def pairs():
    built = {}

    def get(name):
        if name not in built:
            built[name] = build_pair(**PAIRS[name])
        return built[name]

    return get


@pytest.fixture(scope="module")
def inputs():
    rs, te, mask = text_inputs(4)
    neg = rs.randn(B, 3, TEXT_DIM).astype(np.float32)
    return te, mask, neg, gumbel(rs, 16)


CASES = {
    # (pair, sampler, extra generate arguments)
    "token-xla-compact": ("token", "xla", {}),
    "token-fused-cfg_pair-full": ("token", "fused", dict(cfg_fold=False, compact=False)),
    "token-xla-per_row": ("token", "xla", dict(cond_scale=np.array([[2.0, 4.0]], np.float32), compact=False)),
    "token-fused-negative": ("token", "fused", dict(neg=True, compact=False)),
    "self-fused-compact": ("self", "fused", {}),
    "self-xla-negative-ramp": ("self", "xla", dict(neg=True, cond_scale=(1.0, 3.0), compact=False)),
    "token-forced_off": ("token", "xla", dict(force_not_use_token_critic=True, compact=False)),
    "remask-xla": ("remask", "xla", dict(can_remask_prev_masked=True)),
    "remask-fused": ("remask", "fused", dict(can_remask_prev_masked=True, cfg_fold=False)),
    "remask_token-xla-compact": ("remask_token", "xla", dict(can_remask_prev_masked=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_critic_and_remask_decodes_match_jax(pairs, inputs, case):
    name, sampler, kw = CASES[case]
    kw = dict(kw)
    te, mask, neg, noise = inputs
    if kw.pop("neg", False):
        kw["neg_text_embeds"] = neg
    want, got = generate_both(*pairs(name), te, mask, noise, sampler=sampler, critic_noise_scale=0.0, **kw)
    np.testing.assert_array_equal(got, want)


def test_the_critic_steers_the_decode_and_its_noise_is_seeded(pairs, inputs):
    _, pm = pairs("token")
    te, mask, _, noise = inputs
    kw = dict(text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask), timesteps=T, return_ids=True)
    inj = dict(injected_gumbel_noise=torch.from_numpy(noise), **kw)
    quiet = pm.generate(critic_noise_scale=0.0, **inj)
    assert not torch.equal(quiet, pm.generate(force_not_use_token_critic=True, **inj))
    # with its noise on, the critic's draws come from the step generators
    a = pm.generate(generator=torch.Generator().manual_seed(5), critic_noise_scale=20.0, **kw)
    b = pm.generate(generator=torch.Generator().manual_seed(5), critic_noise_scale=20.0, **kw)
    c = pm.generate(generator=torch.Generator().manual_seed(5), critic_noise_scale=0.0, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_critic_modules_and_their_bridge(pairs):
    jm, pm = pairs("self")
    assert isinstance(pm.token_critic, SelfCritic) and pm.token_critic.net is pm.transformer
    assert pm.token_critic.to_pred.bias is not None and pm.token_critic.to_pred.weight.dtype == torch.float32
    np.testing.assert_array_equal(pm.token_critic.to_pred.bias.detach().numpy(), np.asarray(jm.token_critic.to_pred.bias[...]))
    _, pt = pairs("token")
    assert isinstance(pt.token_critic, TokenCritic) and pt.token_critic.dim_out == 1
    with pytest.raises(TypeError, match="dim_out"):
        TokenCritic(num_tokens=8, dim=8, seq_len=4, dim_out=2, text_embed_dim=8, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        type(pm)(image_size=16, transformer=pm.transformer, token_critic=pt.token_critic, self_token_critic=True, device="cpu")


def test_can_remask_needs_training_for_it_and_turns_compact_off(pairs, inputs):
    te, mask, _, noise = inputs
    kw = dict(
        text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask), timesteps=T, return_ids=True,
        injected_gumbel_noise=torch.from_numpy(noise), can_remask_prev_masked=True,
    )
    _, plain = pairs("token")
    with pytest.raises(ValueError, match="no_mask_token_prob"):
        plain.generate(**kw)
    _, pm = pairs("remask")
    assert pm.no_mask_token_prob == 0.1 and pm.cond_drop_prob == 0.5 and pm.self_cond_prob == 0.9
    assert pm.critic_loss_weight == 1.0
    with pytest.warns(UserWarning, match="forcing compact=False"):
        forced = pm.generate(compact=True, **kw)
    assert torch.equal(forced, pm.generate(compact=False, **kw))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(forced, pm.generate(**kw))
