"""The frozen work arithmetic against the counts the benchmark was defined
with: a base request (b32, T18, CFG 3, without the VAE) 33.59 TFLOP, a b64
train step 7.788 TFLOP, one 256px / 512px decode 165.5 / 661.9 GFLOP."""

import json

import pytest

from benchmark import flops
from benchmark.tests.toy import BENCH


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_compact_rows_of_the_base_schedule():
    assert flops.compact_rows(256, 18) == [256] * 6 + [224] * 2 + [192] * 2 + [160] * 2 + [128] + [96] * 2 + [64] + [32] * 2
    assert flops.compact_rows(1024, 18) == [1024] * 6 + [896] * 2 + [768] * 2 + [640] * 2 + [512] + [384] * 2 + [256] + [128] * 2


def test_base_request_and_train_step():
    t = config("muse-base-256")["transformer"]
    kw = dict(dim=t["dim"], depth=t["depth"], vocab=t["num_tokens"], seq_len=t["seq_len"], text_len=64)
    req = flops.maskgit_generate_flops(batch=32, timesteps=18, head_positions_per_step=flops.compact_rows(256, 18), **kw)
    assert req / 1e12 == pytest.approx(33.59, abs=0.005)
    assert flops.maskgit_train_flops(batch=64, **kw) / 1e12 == pytest.approx(7.788, abs=0.0005)


@pytest.mark.parametrize("size, gflop", [(256, 165.5), (512, 661.9)])
def test_vae_decode(size, gflop):
    v = config("muse-base-256")["vae"]
    got = flops.vae_decode_flops(size, dim=v["dim"], layers=v["layers"], codebook_size=v["codebook_size"])
    assert got / 1e9 == pytest.approx(gflop, abs=0.05)


def test_t5_and_kernel_bounds():
    t5 = config("muse-base-256")["t5"]
    per_text = flops.t5_encoder_flops(64, **{k: t5[k] for k in ("d_model", "d_ff", "num_heads", "d_kv", "num_layers")})
    assert 10e9 < per_text < 12e9
    # K1 over (8192, 65536) bf16: bytes-bound, 0.321 ms
    assert flops.k1_launch(8192, 65536).bound_s * 1e3 == pytest.approx(0.3205, abs=0.001)
    # K2 self-attention (64, 256, 8, 64): bytes-bound, 0.0200 ms
    k2 = flops.k2_forward(64, 256, [256] * 64, heads=8, dim_head=64, keys=256)
    assert k2.bound_s * 1e3 == pytest.approx(0.0200, abs=0.0005)
    assert k2.bound_s == k2.bytes / flops.HBM_BYTES_S
    # K2's backward moves more and computes 2.5x the forward's operations
    bwd = flops.k2_backward(64, 256, [256] * 64, heads=8, dim_head=64, keys=256)
    assert bwd.flops == pytest.approx(2.5 * k2.flops) and bwd.bytes > k2.bytes
