"""What decides `correct` in the generation cells.

`Recorder` keeps, for the batches drawn for the check among the first of
the window (the traffic's own, at its temperature), what the timed path
itself produced: the pipeline's T5 embeddings, each decode step's input
ids, head positions and self-conditioning embeddings as the trunk was
handed them, each step's sampled tokens as K1 returned them and the seed
it was handed, the ids handed to the VAE and the served
uint8 images. It wraps those calls on the objects of this run; it copies a
few tensors a step of the recorded batches and changes nothing.

`check` then runs the plain reference (`reference/`) over those batches,
with weights it makes again from the seed, the reference fed each step's
own input ids and self-conditioning embeddings (the program's state,
followed step by step: with random weights the self-conditioning loop
amplifies rounding from step to step, so a reference on its own state
drifts away):

- `t5_err`: the largest gap between the served T5 embeddings and the
  reference's, over the largest reference value;
- `logit_gap` (and `sr_logit_gap` for a super-res stage): the widest gap,
  in logits, by which a sampled token lies below the reference sampler's
  choice at its position (`reference/sampler.py`: the top-k filter, the
  step's temperature and the Philox Gumbel noise of the step's seed), or
  below the reference's top-k threshold;
- `conf_gap` (`sr_conf_gap`): the widest breach of the confidence order,
  in log probability: how far a position that the next step remasked lies
  above one that it kept, by the reference's confidence in the token the
  program put there;
- `selfcond_gap` (`sr_selfcond_gap`): the stage that following the
  program's state skips, checked by itself: the largest gap between the
  self-conditioning embeddings the program hands the next step and the
  reference's embeddings of this step; step 0's must be zeros;
- `trajectory_mismatch`: tokens kept from one step to the next, positions
  remasked that the step before did not fill, ids handed on to the
  super-res stage or to the VAE, and filled positions that differ from
  what the steps before produced (exact: limit 0);
- `pixel_mismatch`: the share of served uint8 values that differ from the
  reference decode of the served ids.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import inspect
import math

import numpy as np
import torch

from benchmark.reference import sampler as ref_sampler
from benchmark.reference import t5 as ref_t5
from benchmark.reference import trunk as ref_trunk
from benchmark.reference import vae as ref_vae


class Recorder:
    def __init__(self, pipe, model, stages: Dict[str, object], decode_vae, chosen):
        import muse_maskgit_pytorch_tpu_torch.models.maskgit as maskgit_module
        from muse_maskgit_pytorch_tpu_torch.ops.sampling_kernel import fused_topk_gumbel_sample as k1_signature

        self.chosen = set(chosen)
        self.batch: Optional[int] = None
        self.records: Dict[int, dict] = {}
        self._stage = None
        self._undo = []

        def keep(obj, name, wrapper):
            orig = getattr(obj, name)
            setattr(obj, name, wrapper(orig))
            self._undo.append((obj, name, orig))

        def on_batch(orig):
            def run(embeds, mask, *a, **kw):
                if self.batch is not None:
                    self.records[self.batch] = dict(embeds=embeds.clone(), mask=mask.clone(), steps={k: [] for k in stages})
                return orig(embeds, mask, *a, **kw)

            return run

        def on_trunk(stage):
            def wrap(orig):
                def run(x, **kw):
                    rec = self._current()
                    if rec is not None:
                        keep = lambda t: None if t is None else t.clone()  # noqa: E731
                        rec["steps"][stage].append(dict(
                            x=x.clone(), gather=keep(kw.get("gather_positions")),
                            cond=keep(kw.get("conditioning_token_ids")), sc=keep(kw.get("self_cond_embed")),
                        ))
                        self._stage = stage
                    return orig(x, **kw)

                return run

            return wrap

        # K1's published signature, whatever the module holds under its name
        sig = inspect.signature(k1_signature)

        def on_k1(orig):

            def run(*a, **kw):
                pred, prob = orig(*a, **kw)
                rec = self._current()
                if rec is not None:
                    args = sig.bind(*a, **kw).arguments
                    rec["steps"][self._stage][-1].update(pred=pred.clone(), seed=args["seed"].reshape(-1)[:1].clone())
                return pred, prob

            return run

        def on_decode(orig):
            def run(ids):
                rec = self._current()
                if rec is not None:
                    rec["decoded_ids"] = ids.clone()
                return orig(ids)

            return run

        keep(pipe, "_generate_batch", on_batch)
        for stage, transformer in stages.items():
            keep(transformer, "forward_with_cond_scale", on_trunk(stage))
        keep(maskgit_module, "fused_topk_gumbel_sample", on_k1)
        keep(decode_vae, "decode_from_ids", on_decode)

    def _current(self):
        return self.records.get(self.batch) if self.batch is not None else None

    def arm(self, batch: Optional[int]) -> None:
        self.batch = batch if batch in self.chosen else None

    def served(self, batch: int, prompts: List[str], images: np.ndarray) -> None:
        if batch in self.records:
            self.records[batch].update(prompts=list(prompts), images=images)

    def close(self) -> None:
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)
        self._undo = []


def _stage_cfgs(cfg: dict) -> Dict[str, dict]:
    out = {"base": cfg["transformer"]}
    if cfg.get("superres"):
        out["superres"] = cfg["superres"]["transformer"]
    return out


@torch.no_grad()
def replay(w: dict, t: dict, steps: List[dict], embeds, mask, cond_scale: float, sampling: dict, mode: str = "f32"):
    """Follow one stage's recorded steps. `sampling`: the top-k count `k`,
    the `temperature` and the step count. Returns the numbers of the stage
    (`gap`, `conf_gap`, `sc_gap`, `mismatch`), the ids after the last step,
    and with `mode` other than "f32" the lower precision's readings
    (`ctl_gap`, `ctl_conf`, `ctl_sc`): its own sampler's choices, its
    confidence order and its self-conditioning, judged by the f32
    reference on the same state."""
    mask_id = t["num_tokens"]
    out = dict(gap=0.0, conf_gap=0.0, sc_gap=0.0, mismatch=0, ctl_gap=0.0, ctl_conf=0.0, ctl_sc=0.0)
    ids = prev = None
    for s, st in enumerate(steps):
        x = st["x"]
        b, n = x.shape
        pred = st["pred"].long().reshape(b, -1)
        npos = pred.shape[1]
        masked = x == mask_id
        if ids is not None:
            out["mismatch"] += int(((x != ids) & ~masked).sum())
        if prev is not None:
            # this step's remasked positions against the confidence order of the last step's
            filled, lp, lp_low = prev
            out["mismatch"] += int((masked & ~filled).sum())
            out["conf_gap"] = max(out["conf_gap"], ref_sampler.remask_gap(lp, filled, masked))
            if lp_low is not None:
                low_set = ref_sampler.least_confident(lp_low, filled, (masked & filled).sum(1))
                out["ctl_conf"] = max(out["ctl_conf"], ref_sampler.remask_gap(lp, filled, low_set))
        if st["gather"] is None:
            counts = masked.sum(1)
            if not bool((counts == counts[0]).all()):
                out["mismatch"] += b * n
                break
            positions = masked.nonzero()[:, 1].reshape(b, -1)
            filled_tok = torch.take_along_dim(pred, positions, dim=1)
            head_rows = positions  # the sampler's row of a position: its place in the grid
        else:
            count = masked.sum(1)
            k = int(count[0])
            positions = st["gather"][:, :k].long()
            out["mismatch"] += int((count != k).sum()) + int((~torch.take_along_dim(masked, positions, dim=1)).sum())
            filled_tok = pred[:, :k]
            head_rows = torch.arange(k, device=x.device).expand(b, k)  # its place among the candidates
        keys = (torch.arange(b, device=x.device)[:, None] * npos + head_rows).reshape(-1)
        seed = int(st["seed"].reshape(-1)[0])
        temp = ref_sampler.step_temperature(sampling["temperature"], s, sampling["steps"])
        self_cond = torch.zeros(b, n, t["dim"], device=x.device) if st["sc"] is None else st["sc"].float()
        if s == 0:
            out["sc_gap"] = max(out["sc_gap"], float(self_cond.abs().max()))
        logits, cond_emb = ref_trunk.guided_step(w, t, x, embeds, mask, st["cond"], self_cond, cond_scale, positions)
        l = logits.reshape(-1, logits.shape[-1])
        tok = filled_tok.reshape(-1)
        gap = ref_sampler.margins(l, tok, sampling["k"], temp, seed, keys)
        out["gap"] = max(out["gap"], float(gap.max()))
        lp = torch.full((b, n), float("nan"), device=x.device)
        lp.scatter_(1, positions, ref_sampler.log_confidence(l, tok).reshape(b, -1))
        filled = torch.zeros_like(masked).scatter_(1, positions, True)
        nxt = steps[s + 1]["sc"] if s + 1 < len(steps) and t["self_cond"] else None
        if nxt is not None:
            out["sc_gap"] = max(out["sc_gap"], float((nxt.float() - cond_emb).abs().max()))
        lp_low = None
        if mode != "f32":
            low, low_emb = ref_trunk.guided_step(w, t, x, embeds, mask, st["cond"], self_cond, cond_scale, positions, mode)
            low = low.reshape(-1, low.shape[-1])
            pick = ref_sampler.choose(low, sampling["k"], temp, seed, keys)
            out["ctl_gap"] = max(out["ctl_gap"], float(ref_sampler.margins(l, pick, sampling["k"], temp, seed, keys).max()))
            lp_low = torch.full((b, n), float("nan"), device=x.device)
            lp_low.scatter_(1, positions, ref_sampler.log_confidence(low, tok).reshape(b, -1))
            if nxt is not None:
                out["ctl_sc"] = max(out["ctl_sc"], float((low_emb - cond_emb).abs().max()))
            del low
        del logits, l
        prev = (filled, lp, lp_low)
        ids = x.clone()
        ids.scatter_(1, positions, filled_tok)
    return out, ids


@torch.no_grad()
def check(cfg: dict, traffic: dict, records: Dict[int, dict], chosen: List[int], weights: Dict[str, dict], device,
          control: bool = False) -> Dict[str, float]:
    """The compared numbers over the `chosen` batches (with `control`, the
    lower precision's readings on the same prompts and tokens besides,
    under `control.<name>`)."""
    t5cfg = cfg["t5"]
    codebook = cfg["vae"]["codebook_size"]
    stages = _stage_cfgs(cfg)
    out = {"t5_err": 0.0, "trajectory_mismatch": 0, "pixel_mismatch": 0.0}
    for st in stages:
        prefix = "" if st == "base" else "sr_"
        out[prefix + "logit_gap"] = out[prefix + "conf_gap"] = out[prefix + "selfcond_gap"] = 0.0
    if control:
        out.update({f"control.{k}": 0.0 for k in list(out) if k != "trajectory_mismatch"})
    for i in chosen:
        rec = records[i]
        b = len(rec["prompts"])
        # the batch as the pipeline encoded it: the prompts, then "" rows to its size
        texts = rec["prompts"] + [""] * (rec["embeds"].shape[0] - b)
        embeds, tmask = ref_t5.encode_texts(weights["t5"], t5cfg, texts, traffic["text_len"], device)
        scale = float(embeds.abs().max())
        out["t5_err"] = max(out["t5_err"], float((rec["embeds"].float() - embeds).abs().max()) / scale)
        if control:
            low, _ = ref_t5.encode_texts(weights["t5"], t5cfg, texts, traffic["text_len"], device, "tf32")
            out["control.t5_err"] = max(out["control.t5_err"], float((low - embeds).abs().max()) / scale)
        handed = None
        for st, t in stages.items():
            steps = rec["steps"][st]
            if handed is not None:
                out["trajectory_mismatch"] += int((steps[0]["cond"].reshape(handed.shape) != handed).sum())
            sampling = dict(
                k=max(math.ceil((1 - traffic["topk_filter_thres"]) * t["num_tokens"]), 1),
                temperature=traffic["temperature"], steps=traffic["timesteps"],
            )
            got, handed = replay(weights[st], t, steps, embeds, tmask, float(traffic["cond_scale"]), sampling,
                                 "fp8" if control else "f32")
            prefix = "" if st == "base" else "sr_"
            out["trajectory_mismatch"] += got["mismatch"]
            for name, key, low in (("logit_gap", "gap", "ctl_gap"), ("conf_gap", "conf_gap", "ctl_conf"),
                                   ("selfcond_gap", "sc_gap", "ctl_sc")):
                out[prefix + name] = max(out[prefix + name], got[key])
                if control:
                    out[f"control.{prefix}{name}"] = max(out[f"control.{prefix}{name}"], got[low])
        served_ids = rec["decoded_ids"]
        out["trajectory_mismatch"] += int((served_ids.reshape(handed.shape) != handed).sum())
        images = torch.from_numpy(np.asarray(rec["images"])).to(device)
        diff = ctl_diff = 0
        for s in range(0, b, 8):
            ref = ref_vae.to_uint8(ref_vae.decode_ids(weights["vae"], served_ids[s : min(b, s + 8)], codebook))
            diff += int((ref != images[s : s + ref.shape[0]]).sum())
            if control:
                low = ref_vae.to_uint8(ref_vae.decode_ids(weights["vae"], served_ids[s : min(b, s + 8)], codebook, "tf32"))
                ctl_diff += int((low != ref).sum())
        out["pixel_mismatch"] = max(out["pixel_mismatch"], diff / images.numel())
        if control:
            out["control.pixel_mismatch"] = max(out["control.pixel_mismatch"], ctl_diff / images.numel())
    return out


def reference_weights(cfg: dict, seed: int, device) -> Dict[str, dict]:
    """The seed's weights again, made by the benchmark for the reference."""
    from benchmark.models import make_weights, meta_modules, specs

    return {k: make_weights(specs(m), seed, k, device) for k, m in meta_modules(cfg).items()}
