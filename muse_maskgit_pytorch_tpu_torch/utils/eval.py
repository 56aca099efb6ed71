"""Generative-quality evaluation: streaming feature statistics and the
Fréchet distance, the FID family (counterpart of
`muse_maskgit_pytorch_tpu/utils/eval.py`).

The distance math is the JAX package's, in numpy, on the host:
`FeatureStats` folds feature batches into float64 first and second moments
(the same numpy operations, so equal features give bit-equal moments), and
`frechet_distance` takes the trace of the matrix square root through two
symmetric eigendecompositions. A statistics file (`save` / `load`, numpy's
`.npz` with the keys `dim`, `n`, `sum`, `outer`) written by either package
loads in the other.

The extractors run the towers on the card (or wherever the tower lives):
`make_inception_extractor` (the standard FID tower, `models.inception`:
antialiased bilinear resize to 299 px, then [-1, 1]) and
`make_vgg_extractor` (`models.vgg`'s fc2 features). Each returns its
features as a tensor on the tower's device; `compute_feature_stats` moves
each batch's features to the host once. Without converted weights
(`utils.convert`) a tower is random-init: its scores order models and catch
drift, but are not comparable across papers.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Array = np.ndarray


def _host(features) -> np.ndarray:
    """Features (numpy, or a tensor on any device) as a host array, moved
    once."""
    if isinstance(features, torch.Tensor):
        return features.detach().cpu().numpy()
    return np.asarray(features)


class FeatureStats:
    """Streaming (mean, covariance) over feature batches.

    First and second moments accumulate in float64 on the host: `update()`
    a batch, `mean_cov()` at the end. `merge()` adds another accumulator's
    moments (the sums are exactly additive); `save()` / `load()` keep the
    raw moments, so a reference set is measured once."""

    def __init__(self, dim: int):
        self.dim = int(dim)
        self.n = 0
        self._sum = np.zeros((dim,), np.float64)
        self._outer = np.zeros((dim, dim), np.float64)

    def update(self, features) -> "FeatureStats":
        f = np.asarray(_host(features), np.float64)
        if f.ndim != 2 or f.shape[1] != self.dim:
            raise ValueError(f"expected (batch, {self.dim}) features, got {f.shape}")
        self.n += f.shape[0]
        self._sum += f.sum(axis=0)
        self._outer += f.T @ f
        return self

    def merge(self, other: "FeatureStats") -> "FeatureStats":
        if other.dim != self.dim:
            raise ValueError(f"dim mismatch: {self.dim} vs {other.dim}")
        self.n += other.n
        self._sum += other._sum
        self._outer += other._outer
        return self

    def mean_cov(self) -> Tuple[Array, Array]:
        if self.n < 2:
            raise ValueError(f"need >= 2 samples for a covariance, have {self.n}")
        mu = self._sum / self.n
        # unbiased: (sum x x^T - n mu mu^T) / (n - 1)
        cov = (self._outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov

    def save(self, path) -> str:
        """Write the moments; returns the name written: numpy appends
        `.npz` to any other suffix ('coco.ref' -> 'coco.ref.npz')."""
        path = Path(path)
        np.savez(path, dim=self.dim, n=self.n, sum=self._sum, outer=self._outer)
        return str(path if path.suffix == ".npz" else Path(str(path) + ".npz"))

    @classmethod
    def load(cls, path) -> "FeatureStats":
        with np.load(path) as z:
            stats = cls(int(z["dim"]))
            stats.n = int(z["n"])
            stats._sum = z["sum"].astype(np.float64)
            stats._outer = z["outer"].astype(np.float64)
        return stats


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """Fréchet distance between two gaussians,
    |mu1 - mu2|^2 + tr(cov1 + cov2 - 2 (cov1 cov2)^(1/2)).

    tr sqrt(C1 C2) = sum sqrt(eig(C1^(1/2) C2 C1^(1/2))): two symmetric
    eigendecompositions, deterministic and robust to the tiny negative
    eigenvalues of sample covariances. `eps` regularises both covariances
    (rank-deficient when there are fewer samples than dimensions)."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    cov1 = np.asarray(cov1, np.float64) + eps * np.eye(mu1.shape[0])
    cov2 = np.asarray(cov2, np.float64) + eps * np.eye(mu2.shape[0])

    diff = mu1 - mu2
    w1, v1 = np.linalg.eigh(cov1)
    sqrt_c1 = (v1 * np.sqrt(np.clip(w1, 0, None))) @ v1.T
    inner = sqrt_c1 @ cov2 @ sqrt_c1
    w = np.linalg.eigvalsh((inner + inner.T) / 2)
    tr_sqrt = np.sqrt(np.clip(w, 0, None)).sum()
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * tr_sqrt)


def fid_score(stats_real: FeatureStats, stats_fake: FeatureStats) -> float:
    """Fréchet distance between two accumulated feature distributions."""
    mu1, c1 = stats_real.mean_cov()
    mu2, c2 = stats_fake.mean_cov()
    return frechet_distance(mu1, c1, mu2, c2)


def compute_feature_stats(
    batches: Iterable,
    extract_fn: Callable,
    dim: Optional[int] = None,
    stats: Optional[FeatureStats] = None,
) -> FeatureStats:
    """Fold an iterable of image batches through `extract_fn` ((b, H, W, 3)
    images -> (b, d) features, a tensor on any device or an array) into
    `FeatureStats`; each batch's features reach the host once. Pass `stats`
    to continue accumulating."""
    for batch in batches:
        feats = _host(extract_fn(batch))
        if stats is None:
            stats = FeatureStats(dim if dim is not None else feats.shape[1])
        stats.update(feats)
    if stats is None:
        raise ValueError("no batches")
    return stats


def _images(images, device: torch.device) -> torch.Tensor:
    """A batch (numpy or a tensor) as f32 on the tower's device."""
    if not isinstance(images, torch.Tensor):
        images = torch.as_tensor(np.asarray(images))
    return images.to(device=device, dtype=torch.float32)


def make_vgg_extractor(vgg=None, seed: int = 0, device="cuda") -> Callable:
    """(b, H, W, 3) in [0, 1] -> (b, 4096) features: the port's `VGG16`
    fc2 embedding (the GAN's perceptual tower), without gradients. Pass a
    `VGG16` with converted weights for comparable scores; the default
    random init (from `seed`, on `device`) is only self-consistent."""
    from muse_maskgit_pytorch_tpu_torch.models.vgg import VGG16

    if vgg is None:
        vgg = VGG16(generator=torch.Generator().manual_seed(seed), device=device)
    dev = next(vgg.parameters()).device

    @torch.no_grad()
    def extract(images) -> torch.Tensor:
        return vgg(_images(images, dev))

    return extract


def make_inception_extractor(inception=None, seed: int = 0, resize_to: Optional[int] = 299, device="cuda") -> Callable:
    """(b, H, W, 3) in [0, 1] -> (b, 2048) pool3 features of the port's
    `InceptionV3`, the standard FID tower, without gradients. The
    pytorch-fid input convention: a bilinear resize to `resize_to` squared
    (None skips it), antialiased as `jax.image.resize` is when it shrinks,
    in f32, then x * 2 - 1. Pass an `InceptionV3` loaded by
    `utils.convert.load_torchvision_inception_v3` for scores comparable to
    other torchvision-weight FID implementations (most published FIDs use
    pytorch-fid's TF-ported checkpoint, which differs systematically); the
    default random init (from `seed`, on `device`) only orders models."""
    from muse_maskgit_pytorch_tpu_torch.models.inception import InceptionV3

    if inception is None:
        inception = InceptionV3(generator=torch.Generator().manual_seed(seed), device=device)
    dev = next(inception.parameters()).device

    @torch.no_grad()
    def extract(images) -> torch.Tensor:
        x = _images(images, dev)
        if resize_to is not None and tuple(x.shape[1:3]) != (resize_to, resize_to):
            x = F.interpolate(
                x.permute(0, 3, 1, 2), size=(resize_to, resize_to), mode="bilinear", align_corners=False,
                antialias=True,
            ).permute(0, 2, 3, 1)
        return inception(x * 2.0 - 1.0)

    return extract
