"""The port's spans (`utils.metrics.span`, the `muse.*` names) on the CPU, at
a toy size, and the benchmark's readers of them:

  (a) under `torch.profiler` a base `GeneratePipeline` call, a cascade call
      and a `MaskGitTrainer` step record their spans, nested as the layers
      are (a decode step holds its remask, trunk, sampler and scores);
  (b) with no profiler running a span is the shared no-op and no record is
      made; under the profiler each span is one record;
  (c) `export_pipeline`'s graph holds no profiler node, traced with the
      profiler off or on, and the program's images equal eager `generate`'s;
  (d) the six readers (`benchmark/metrics/`) of the span metrics give
      their numbers from a hand-made trace whose kernels carry span chains,
      and nothing from one whose kernels carry none (a program without the
      spans).
"""

import tempfile

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import ROOT, Trace, load_module
from muse_maskgit_pytorch_tpu_torch import export_pipeline
from muse_maskgit_pytorch_tpu_torch.serving import _quantize_u8
from muse_maskgit_pytorch_tpu_torch.utils import metrics
from tests.test_torch_serving import TEXT_LEN, cascade, pipe, toy_maskgit
from tests.test_torch_trainer import _ids_batches, _trainer

T = 2  # the toy pipelines' timesteps
STEP_PARTS = ["muse.remask", "muse.trunk", "muse.sample", "muse.scores"]


def _run(kind):
    """A callable running one warmed request or train step of `kind`."""
    if kind == "train":
        trainer = _trainer(tempfile.mkdtemp())
        trainer.maskgit.self_cond_prob = 1.0  # every step runs the self-conditioning pass
        batches = _ids_batches(2)
        trainer.train_step_arrays(*batches[0])
        return lambda: trainer.train_step_arrays(*batches[1])
    p = pipe(cascade() if kind == "cascade" else toy_maskgit(), timesteps=T)
    p(["a", "b"])
    return lambda: p(["a cat", "b"])


def _spans(fn):
    """The `muse.*` host events of one traced call of `fn`."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith("muse.")]


def _parents(e):
    out, p = [], e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def _named(events, name):
    return [e for e in events if e.name == name]


@pytest.mark.parametrize("kind", ["base", "cascade", "train"])
def test_spans_nest_as_the_layers(kind):
    events = _spans(_run(kind))
    if kind == "train":
        (step,) = _named(events, "muse.train_step")
        assert _parents(step) == []
        (fwd,) = _named(events, "muse.forward")
        assert _parents(fwd) == ["muse.train_step"]
        for name in ("muse.loss", "muse.self_cond"):
            (e,) = _named(events, name)
            assert _parents(e)[:2] == ["muse.forward", "muse.train_step"]
        for name in ("muse.backward", "muse.optimizer", "muse.ema"):
            (e,) = _named(events, name)
            assert _parents(e) == ["muse.train_step"]
        return
    (request,) = _named(events, "muse.request")
    assert _parents(request) == []
    for name in ("muse.t5", "muse.vae_decode", "muse.to_host"):
        (e,) = _named(events, name)
        assert "muse.request" in _parents(e)
    steps = _named(events, "muse.step")
    stages = ["muse.base", "muse.superres"] if kind == "cascade" else [None]
    assert len(steps) == T * len(stages)
    assert len(_named(events, "muse.context_kv")) == len(stages)
    for stage in stages:
        mine = [s for s in steps if stage is None or stage in _parents(s)]
        assert len(mine) == T
        if stage is not None:
            (e,) = _named(events, stage)
            assert _parents(e) == ["muse.request"]
    for s in steps:
        assert [c.name for c in s.cpu_children if c.name.startswith("muse.")] == STEP_PARTS
    for name in STEP_PARTS:
        assert all(_parents(e)[0] == "muse.step" for e in _named(events, name))


@pytest.mark.parametrize("kind", ["base", "train"])
def test_span_records_nothing_without_the_profiler(kind, monkeypatch):
    made = []
    record = metrics._record

    def counted(name):
        made.append(name)
        return record(name)

    monkeypatch.setattr(metrics, "_record", counted)
    run = _run(kind)
    made.clear()
    run()
    assert made == []
    assert metrics.span("muse.a") is metrics.span("muse.b")  # the one shared no-op
    events = _spans(run)
    assert sorted(made) == sorted(e.name for e in events) and made


@pytest.mark.parametrize("traced", [False, True], ids=["profiler_off", "profiler_on"])
def test_export_holds_no_profiler_node(traced):
    model = toy_maskgit()
    kw = dict(batch_size=2, text_len=TEXT_LEN, timesteps=T)
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            ep = export_pipeline(model, **kw)
    else:
        ep = export_pipeline(model, **kw)
    targets = [str(n.target) for n in ep.program.graph.nodes if n.op == "call_function"]
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
    te = torch.randn(2, TEXT_LEN, model.transformer.text_embed_dim)
    tm = torch.ones(2, TEXT_LEN, dtype=torch.bool)
    images = model.generate(generator=torch.Generator().manual_seed(3), text_embeds=te, text_mask=tm, timesteps=T)
    want = _quantize_u8(images)
    assert torch.equal(ep(model.state_dict(), te, tm, torch.Generator().manual_seed(3)), want)


# -- (d) the readers ----------------------------------------------------------------------

R, RS = ("muse.request",), ("muse.train_step",)
STEP = ("muse.step", "muse.base") + R
# (kernel, seconds, host events above its launch, innermost first): a
# generation batch and a train step of 4 images / steps
ROWS = [
    ("nvjet_tst_gemm", 0.004, ("aten::mm", "aten::linear", "muse.trunk") + STEP),
    ("elementwise_kernel<mul>", 0.002, ("aten::mul", "muse.trunk") + STEP),
    ("flash_core_kernel<64, true>", 0.001, ("muse_torch::qknorm_attend", "muse.trunk") + STEP),
    ("sample_kernel<bf16>", 0.001, ("muse_torch::fused_topk_gumbel_sample", "muse.sample") + STEP),
    ("radixSortKVInPlace", 0.0005, ("aten::sort", "muse.remask") + STEP),
    ("elementwise_kernel<where>", 0.00025, ("aten::where", "muse.scores") + STEP),
    ("t5_gemm", 0.003, ("aten::mm", "aten::linear", "muse.t5") + R),
    ("elementwise_kernel<add>", 0.001, ("aten::add", "muse.t5") + R),
    ("dgrad_engine", 0.006, ("aten::cudnn_convolution", "aten::convolution", "muse.vae_decode") + R),
    ("group_norm_kernel", 0.002, ("aten::group_norm", "muse.vae_decode") + R),
    ("Memcpy DtoH", 0.0001, ("aten::copy_", "muse.to_host") + R),
    ("fwd_gemm", 0.01, ("aten::mm", "muse.forward") + RS),
    ("exp_kernel", 0.005, ("aten::exp", "muse.loss", "muse.forward") + RS),
    ("bwd_gemm", 0.02, ("aten::mm", "autograd::engine::evaluate_function: MmBackward0")),
    ("multi_tensor_apply<adam>", 0.003, ("aten::_foreach_mul_", "muse.optimizer") + RS),
    ("multi_tensor_apply<lerp>", 0.001, ("aten::_foreach_lerp_", "muse.ema") + RS),
]
WANT = {  # ms per unit
    "t5_ms_per_img.gen": (0.003 + 0.001) / 4e-3,
    "trunk_glue_ms_per_img.gen": 0.002 / 4e-3,
    "loop_glue_ms_per_img.cascade": (0.0005 + 0.00025) / 4e-3,
    "vae_total_ms_per_img.gen": (0.006 + 0.002) / 4e-3,
    "forward_ms_per_step.train": (0.01 + 0.005) / 4e-3,
    "optim_ms_per_step.train": (0.003 + 0.001) / 4e-3,
}


class _Reading:
    def __init__(self, rows):
        self.trace = Trace.__new__(Trace)
        self.trace.kernels, self.trace.units = rows, 4


@pytest.mark.parametrize("metric", sorted(WANT))
def test_span_metric_reader(metric):
    reader = load_module(ROOT / "benchmark" / "metrics" / f"{metric.split('.')[0]}.py")
    assert reader.read(_Reading(ROWS)) == pytest.approx(WANT[metric], rel=1e-12)
    # the same kernels as a program without spans launches them
    bare = [(k, s, tuple(op for op in chain if not op.startswith("muse."))) for k, s, chain in ROWS]
    assert reader.read(_Reading(bare)) is None
