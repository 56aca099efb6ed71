"""The port's example command lines (`muse_maskgit_pytorch_tpu_torch/examples`)
on the CPU: every `--help`, `python -m` as a user runs them, and a toy run
of each in-process through `main(argv)` with `--device cpu` (the server on
127.0.0.1 under the load drive),
checking that what each writes exists and reads back: PNGs through the
port's decoder, statistics files through the JAX package's `FeatureStats`,
shards through the JAX package's shard header reader, VAE files through the
flax's msgpack reader.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from flax.serialization import msgpack_restore

from muse_maskgit_pytorch_tpu.training.shard_loader import read_shard_header
from muse_maskgit_pytorch_tpu.utils.eval import FeatureStats as JFeatureStats

from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer, VQGanVAE
from muse_maskgit_pytorch_tpu_torch.examples import (
    compute_fid,
    e2e_demo,
    edit_image,
    fetch_and_convert,
    fsdp_memory_report,
    load_test,
    sample,
    serve,
    smoke_e2e,
    tokenize_dataset,
    train_maskgit,
    train_vqgan,
)
from muse_maskgit_pytorch_tpu_torch.models import t5 as pt5
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import flatten_tree, to_jax_state
from muse_maskgit_pytorch_tpu_torch.utils.png import decode_png, encode_png
from tests.torch_threads import few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CLIS = {
    m.__name__.rsplit(".", 1)[1]: m
    for m in (
        compute_fid, sample, train_maskgit, train_vqgan, tokenize_dataset, edit_image, serve, load_test, smoke_e2e,
        e2e_demo, fetch_and_convert, fsdp_memory_report,
    )
}
T5 = "test/cli-tiny-t5"  # registered below: random init, the byte tokenizer, no files
VAE_DIM, VOCAB, DIM, N_IMAGES, SIZE = 16, 16, 32, 20, 32



@pytest.fixture(scope="module", autouse=True)
def tiny_t5():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(pt5.T5_CONFIGS, T5, pt5.T5Config(32, 64, 2, 16, 1, True))
        yield


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """20 seeded 32px PNGs, every other one with a caption."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for i in range(N_IMAGES):
        (d / f"{i:02d}.png").write_bytes(encode_png(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)))
        if i % 2 == 0:
            (d / f"{i:02d}.txt").write_text(f"a picture number {i}")
    return d


@pytest.fixture(scope="module")
def vae_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vae") / "vae.msgpack"
    VQGanVAE(dim=VAE_DIM, codebook_size=VOCAB, generator=torch.Generator().manual_seed(3), device="cpu").save(path)
    return path


def _png(path):
    img = decode_png(Path(path).read_bytes())
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
    return img


@pytest.mark.parametrize("name", sorted(CLIS))
def test_help(name, capsys):
    with pytest.raises(SystemExit) as exit_:
        CLIS[name].main(["--help"])
    out = capsys.readouterr().out
    assert exit_.value.code == 0 and out.startswith("usage:")
    assert ("--device" in out) == (name != "load_test")  # a client builds no model


def test_runs_as_a_module():
    """`python -m` from the checkout, as a user runs it; imports no JAX."""
    code = (
        "import runpy, sys; sys.argv = ['compute_fid', '--help']\n"
        "try:\n    runpy.run_module('muse_maskgit_pytorch_tpu_torch.examples.compute_fid', run_name='__main__')\n"
        "except SystemExit as e:\n    assert e.code == 0\n"
        "assert not [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax'))]\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "usage:" in out.stdout and "--extractor" in out.stdout


def test_compute_fid(tmp_path):
    """Four 32px images (resized to 299 for the tower), in batches of 2, the
    last one dropped (a fixed sample count)."""
    real = tmp_path / "real"
    real.mkdir()
    rng = np.random.default_rng(4)
    for i in range(5):
        (real / f"{i}.png").write_bytes(encode_png(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)))
    common = ["--image-size", str(SIZE), "--batch-size", "2", "--device", "cpu"]
    stats = tmp_path / "real.ref"
    assert compute_fid.main(["--real", str(real), "--save-stats", str(stats), *common]) is None
    saved = JFeatureStats.load(str(stats) + ".npz")  # the JAX package reads the file
    assert (saved.n, saved.dim) == (4, 2048)
    fid = compute_fid.main(["--stats", str(stats) + ".npz", "--fake", str(real), *common])
    assert abs(fid) < 1e-4  # one set against itself
    with pytest.raises(SystemExit, match="need --real or --stats"):
        compute_fid.main(common)


@pytest.fixture(scope="module")
def base_checkpoint(tmp_path_factory):
    """A 256px base MaskGit file at toy widths (the CLIs' base stage)."""
    vae = VQGanVAE(dim=VAE_DIM, codebook_size=VOCAB, use_vgg_and_gan=False, device="cpu")
    transformer = MaskGitTransformer(num_tokens=VOCAB, seq_len=256, dim=DIM, depth=1, t5_name=T5, device="cpu")
    ckpt = tmp_path_factory.mktemp("base") / "base.msgpack"
    MaskGit(image_size=256, transformer=transformer, vae=vae, device="cpu").save(ckpt)
    return ckpt


def _model_args(ckpt):
    return [
        "--base-checkpoint", str(ckpt), "--vae-dim", str(VAE_DIM), "--codebook-size", str(VOCAB), "--dim", str(DIM),
        "--depth", "1", "--t5-name", T5, "--timesteps", "2", "--device", "cpu",
    ]


def test_sample(tmp_path, capsys, base_checkpoint):
    paths = sample.main([
        "a red fox", "a blue bird", *_model_args(base_checkpoint), "--cond-scale", "2", "--cond-scale-end", "1",
        "--negative-prompt", "blur", "--image-size", "64x128", "--out-prefix", str(tmp_path / "out"),
    ])
    assert paths == [str(tmp_path / f"out_{i}.png") for i in range(2)]
    assert all(_png(p).shape == (64, 128, 3) for p in paths)
    assert "saved" in capsys.readouterr().out


def test_edit_image(tmp_path, base_checkpoint):
    """A 64px source scaled to 256, the right half regenerated."""
    src, mask = tmp_path / "src.png", tmp_path / "mask.png"
    src.write_bytes(encode_png(np.random.default_rng(1).integers(0, 256, (64, 64, 3), dtype=np.uint8)))
    m = np.zeros((64, 64), np.uint8)
    m[:, 32:] = 255
    mask.write_bytes(encode_png(m))
    out = tmp_path / "edited.png"
    edited = edit_image.main(["a cat", "--image", str(src), "--mask", str(mask), "--out", str(out),
                              *_model_args(base_checkpoint)])
    assert edited.shape == (256, 256, 3) and _png(out).shape == (256, 256, 3)


def test_serve_and_load_test(base_checkpoint, capsys):
    """The server on 127.0.0.1 (a free port) under the load drive's mixed
    traffic: every request answered, no build in mid-traffic."""
    server = serve.start([*_model_args(base_checkpoint), "--port", "0", "--batch-size", "2", "--text-len", "8",
                          "--warmup-surfaces", "all"])
    try:
        with pytest.raises(SystemExit) as exit_:
            load_test.main(["--port", str(server.port), "--threads", "2", "--requests", "5",
                            "--latency-budget", "120"])
        assert exit_.value.code == 0 and "LOAD TEST PASSED" in capsys.readouterr().out
    finally:
        server.stop()


def test_smoke_e2e(tmp_path):
    out = tmp_path / "smoke.png"
    images = smoke_e2e.main(["--cpu", "--vae-steps", "2", "--maskgit-steps", "2", "--out", str(out)])
    assert images.shape == (4, 32, 32, 3) and _png(out).shape[2] == 3


def test_e2e_demo(tmp_path):
    """The demo's whole flow at toy size (the semantic gates need its full
    training, so they are not asserted here)."""
    report = e2e_demo.run_demo(
        tmp_path, image_size=16, n_images=32, vae_steps=2, maskgit_steps=2, vae_dim=16, codebook_size=16, mg_dim=32,
        mg_depth=1, batch_size=8, gen_per_caption=1, timesteps=2, device="cpu", log=lambda *a: None,
    )
    assert 0.0 <= report["caption_match"] <= 1.0 and np.isfinite(report["recon_psnr_db"])
    assert _png(tmp_path / "samples.png").shape[2] == 3 and (tmp_path / "report.json").exists()
    assert e2e_demo.classify(e2e_demo.render("red", "square", "white", 32)) == ("red", "square", "white")


def test_train_vqgan(folder, tmp_path, monkeypatch):
    """Two GAN steps; the perceptual tower is a stand-in (a CPU random init
    of VGG16's 138 M parameters takes seconds; the tower has tests of its
    own)."""
    from muse_maskgit_pytorch_tpu_torch.models import vgg

    class Tower(nn.Module):
        def __init__(self, **_):
            super().__init__()
            self.proj = nn.Linear(3, 8)

        def forward(self, x):
            return self.proj(x.mean(dim=(1, 2)))

    monkeypatch.setattr(vgg, "VGG16", Tower)
    out = tmp_path / "results"
    trainer = train_vqgan.main([
        "--folder", str(folder), "--image-size", str(SIZE), "--dim", str(VAE_DIM), "--codebook-size", str(VOCAB),
        "--batch-size", "2", "--grad-accum-every", "1", "--num-train-steps", "2", "--results-folder", str(out),
        "--device", "cpu",
    ])
    assert trainer.steps == 2
    assert _png(out / "0.png").shape[2] == 3 and _png(out / "0.ema.png").shape[2] == 3
    # a file in the JAX package's format: flax's msgpack of the JAX layout
    # (saved at step 0, so the leaves' shapes, not the values, of the end)
    tree = flatten_tree(msgpack_restore((out / "vae.0.ema.pt").read_bytes()))
    want = flatten_tree(to_jax_state(trainer.vae_module(use_ema=True)))
    assert tree.keys() == {k for k in want if not k.startswith("_vgg.")}
    assert all(tree[k].shape == want[k].shape and tree[k].dtype == want[k].dtype for k in tree)
    # --shard-state in one process: nothing to shard over, and it trains
    sharded = train_vqgan.main([
        "--folder", str(folder), "--image-size", str(SIZE), "--dim", str(VAE_DIM), "--codebook-size", str(VOCAB),
        "--batch-size", "2", "--grad-accum-every", "1", "--num-train-steps", "1", "--results-folder",
        str(tmp_path / "sharded"), "--shard-state", "--device", "cpu",
    ])
    assert sharded.steps == 1 and not sharded.gen_dp.sharded


def test_train_maskgit(folder, vae_file, tmp_path):
    common = [
        "--vae-checkpoint", str(vae_file), "--vae-dim", str(VAE_DIM), "--codebook-size", str(VOCAB),
        "--image-size", str(SIZE), "--dim", str(DIM), "--depth", "1", "--batch-size", "2", "--t5-name", T5,
        "--device", "cpu",
    ]
    out = tmp_path / "images"
    trainer = train_maskgit.main(["--folder", str(folder), "--num-train-steps", "2", "--results-folder", str(out), *common])
    assert trainer.steps == 2 and (out / "checkpoints").is_dir()
    # from token shards (the native loader), with captions
    shards = tokenize_dataset.main([
        "--folder", str(folder), "--vae-checkpoint", str(vae_file), "--vae-dim", str(VAE_DIM),
        "--codebook-size", str(VOCAB), "--image-size", str(SIZE), "--batch-size", "8", "--captions",
        "--out-prefix", str(tmp_path / "tok" / "shard"), "--device", "cpu",
    ])
    trainer = train_maskgit.main([
        "--token-shards", *shards, "--shard-captions", "--num-train-steps", "2",
        "--results-folder", str(tmp_path / "shards"), *common,
    ])
    assert trainer.steps == 2
    sharded = train_maskgit.main([
        "--folder", str(folder), "--num-train-steps", "1", "--results-folder", str(tmp_path / "sharded"),
        "--shard-state", *common,
    ])
    assert sharded.steps == 1 and not sharded.dp.sharded


@pytest.mark.parametrize("mode", ["square", "buckets", "paired"])
def test_tokenize_dataset(folder, vae_file, tmp_path, mode):
    args = [
        "--folder", str(folder), "--vae-checkpoint", str(vae_file), "--vae-dim", str(VAE_DIM),
        "--codebook-size", str(VOCAB), "--batch-size", "8", "--shard-size", "16", "--captions",
        "--out-prefix", str(tmp_path / "tok" / "shard"), "--device", "cpu",
    ]
    args += {"square": ["--image-size", "32"], "buckets": ["--image-size", "32", "--auto-bucket", "2"],
             "paired": ["--image-size", "32", "--cond-image-size", "16"]}[mode]
    shards = tokenize_dataset.main(args)
    headers = [read_shard_header(s) for s in shards]  # the JAX package's reader
    assert sum(h["num_seqs"] for h in headers) == N_IMAGES
    if mode == "square":
        assert len(shards) == 2 and all(h["seq_len"] == 4 and h["grid"] == (2, 2) for h in headers)
    if mode == "paired":  # 2x2 target ids then the 16px copy's 1x1
        assert all(h["seq_len"] == 5 and h["grid"] == (2, 2) for h in headers)
    captions = [Path(s + ".captions") for s in shards]
    assert all(c.exists() for c in captions)


@pytest.fixture
def no_sockets(monkeypatch):
    """Any socket this process connects or binds fails the test."""
    import socket

    def refuse(self, address, *a):
        raise AssertionError(f"a socket was opened to {address}")

    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket.socket, "connect_ex", refuse)
    monkeypatch.setattr(socket.socket, "bind", refuse)


def test_fetch_and_convert(tmp_path, no_sockets):
    """The offline converter on a randomly initialised InceptionV3 (the T5
    and VGG16 dry runs take the same path), then --verify; a truncated file
    fails --verify."""
    out = tmp_path / "weights"
    written = fetch_and_convert.main(["--dry-run", "inception", "--out", str(out), "--device", "cpu"])
    assert [p.name for p in written] == ["inception_v3.msgpack"]
    assert fetch_and_convert.main(["--out", str(out), "--verify"]) == 1
    # the JAX package's reader takes the file: flax's msgpack of the JAX layout
    tree = flatten_tree(msgpack_restore(written[0].read_bytes()))
    assert any(k.endswith("conv.kernel") and v.ndim == 4 for k, v in tree.items())
    written[0].write_bytes(written[0].read_bytes()[:-10])
    with pytest.raises(ValueError, match="size"):
        fetch_and_convert.main(["--out", str(out), "--verify"])
    with pytest.raises(SystemExit, match="nothing requested"):
        fetch_and_convert.main(["--out", str(out)])


def test_fsdp_memory_report(tmp_path, no_sockets):
    """Two gloo ranks on the CPU, a toy VAE: the sharded state per rank is
    about half the replicated one, which every rank holds whole. This
    process only reads a file store; the ranks talk over loopback."""
    rows = fsdp_memory_report.main([
        "--device", "cpu", "--ranks", "2", "--dim", "32", "--layers", "2", "--image-size", "32", "--codebook", "256",
        "--json", str(tmp_path / "rows.json"),
    ])
    rep, sh = rows["replicated"], rows["sharded"]
    assert rep["total"] == sh["total"] == rep["per_rank"]
    assert 0.5 * rep["total"] < sh["per_rank"] < 0.6 * rep["total"]
    assert sh["ranks"][0] == sh["ranks"][1]
