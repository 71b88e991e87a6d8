"""Gradient-boosting losses with first- and second-order derivatives.

The port's counterpart of `src/repro/core/losses.py`, on torch tensors:

  n_raw(n_classes)   width of the raw prediction vector
  init_raw(y)        base score, (N, C) f32
  grad_hess(raw, y)  (g, h), both (N, C) f32
  value(raw, y)      scalar training objective
  metric(raw, y)     the paper's quality metric (Table 5)

Labels follow the JAX package's dtypes: float32 targets, int32 class ids.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


class Loss:
    name: str = "base"

    def n_raw(self, n_classes: int) -> int:
        return 1

    def init_raw(self, y: torch.Tensor) -> torch.Tensor:
        return torch.zeros((y.shape[0], self.n_raw(0)), dtype=torch.float32,
                           device=y.device)

    def grad_hess(self, raw, y):
        raise NotImplementedError

    def value(self, raw, y):
        raise NotImplementedError

    def metric(self, raw, y):
        raise NotImplementedError


def as_labels(y, device: torch.device | str) -> torch.Tensor:
    """Labels as the JAX package holds them with 64-bit types off (float32
    targets, int32 class ids), on `device`."""
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    y = np.asarray(y)
    if y.dtype == np.float64:
        y = y.astype(np.float32)
    elif y.dtype == np.int64:
        y = y.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(y)).to(device)


def _full(y: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """(N, 1) f32 filled with the scalar tensor `value`."""
    return value.to(torch.float32).reshape(1, 1).expand(y.shape[0], 1) \
        .contiguous()


def _unit_step(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return g[:, None], torch.ones_like(g)[:, None]


@dataclasses.dataclass(eq=False)
class RMSE(Loss):
    name: str = "RMSE"

    def init_raw(self, y):
        return _full(y, y.float().mean())

    def grad_hess(self, raw, y):
        return _unit_step(raw[:, 0] - y)

    def value(self, raw, y):
        # L = 1/2 (r - y)^2, so grad = r - y and hess = 1
        return 0.5 * ((raw[:, 0] - y) ** 2).mean()

    def metric(self, raw, y):
        return torch.sqrt(((raw[:, 0] - y) ** 2).mean())


@dataclasses.dataclass(eq=False)
class MAE(Loss):
    """CatBoost MAE: gradient = sign, unit hessian (a gradient step)."""
    name: str = "MAE"

    def init_raw(self, y):
        # jnp.median averages the two middle values of an even count
        # (torch.median would return the lower one)
        return _full(y, torch.quantile(y.float(), 0.5,
                                       interpolation="midpoint"))

    def grad_hess(self, raw, y):
        return _unit_step(torch.sign(raw[:, 0] - y))

    def value(self, raw, y):
        return (raw[:, 0] - y).abs().mean()

    def metric(self, raw, y):
        return self.value(raw, y)


@dataclasses.dataclass(eq=False)
class Quantile(Loss):
    alpha: float = 0.5
    name: str = "Quantile"

    def init_raw(self, y):
        return _full(y, torch.quantile(y.float(), self.alpha))

    def grad_hess(self, raw, y):
        d = raw[:, 0] - y
        g = torch.where(d > 0, 1.0 - self.alpha, -self.alpha).float()
        return _unit_step(g)

    def value(self, raw, y):
        d = y - raw[:, 0]
        return torch.maximum(self.alpha * d, (self.alpha - 1.0) * d).mean()

    def metric(self, raw, y):
        return self.value(raw, y)


@dataclasses.dataclass(eq=False)
class LogLoss(Loss):
    name: str = "LogLoss"

    def init_raw(self, y):
        p = torch.clip(y.float().mean(), 1e-6, 1 - 1e-6)
        return _full(y, torch.log(p / (1 - p)))

    def grad_hess(self, raw, y):
        p = torch.sigmoid(raw[:, 0])
        return (p - y)[:, None], torch.clamp(p * (1 - p), min=1e-12)[:, None]

    def value(self, raw, y):
        z = raw[:, 0]
        return (torch.logaddexp(torch.zeros_like(z), z) - y * z).mean()

    def metric(self, raw, y):
        """Accuracy (paper Table 5 reports accuracy)."""
        return ((raw[:, 0] > 0).float() == y).float().mean()


@dataclasses.dataclass(eq=False)
class MultiClass(Loss):
    n_classes: int = 2
    name: str = "MultiClass"

    def n_raw(self, n_classes: int) -> int:
        return self.n_classes

    def init_raw(self, y):
        return torch.zeros((y.shape[0], self.n_classes), dtype=torch.float32,
                           device=y.device)

    def grad_hess(self, raw, y):
        p = torch.softmax(raw, dim=-1)
        onehot = torch.nn.functional.one_hot(y.long(), self.n_classes)
        g = p - onehot.float()
        h = torch.clamp(p * (1 - p), min=1e-12)
        return g, h

    def value(self, raw, y):
        logp = torch.log_softmax(raw, dim=-1)
        return -torch.take_along_dim(logp, y.long()[:, None], dim=1).mean()

    def metric(self, raw, y):
        return (torch.argmax(raw, dim=-1) == y.long()).float().mean()


@dataclasses.dataclass(eq=False)
class PairLogitGrouped(Loss):
    """Grouped pairwise ranking (YetiRank-family surrogate).

    `group_index` is a (G, S) int32 matrix of flat sample ids, padded with
    -1.  Gradients are computed on the padded (G, S, S) pairwise tensor
    and scattered back to the flat layout."""
    group_index: Optional[np.ndarray] = None     # (G, S) int32, -1 padded
    name: str = "PairLogit"

    def _index(self, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.group_index),
                               dtype=torch.int64, device=device)

    def _pairs(self, raw, y):
        """(s_i - s_j, pair mask) over each group's (S, S) pairs, where
        sample i is more relevant than j and both are real."""
        gi = self._index(raw.device)
        safe = gi.clamp(min=0)
        valid = gi >= 0
        s, rel = raw[:, 0][safe], y[safe]
        diff = s[:, :, None] - s[:, None, :]
        better = rel[:, :, None] > rel[:, None, :]
        pair_ok = (better & valid[:, :, None] & valid[:, None, :]).float()
        return diff, pair_ok, s, gi

    def grad_hess(self, raw, y):
        diff, pair_ok, _, gi = self._pairs(raw, y)
        sig = torch.sigmoid(-diff)            # d/ds_i log(1 + e^-(si - sj))
        # for each ordered pair (i better than j): g_i -= sig, g_j += sig
        g_pad = (-sig * pair_ok).sum(2) + (sig * pair_ok).sum(1)
        curv = sig * (1 - sig) * pair_ok
        h_pad = curv.sum(2) + curv.sum(1)
        safe = gi.clamp(min=0).reshape(-1)
        w = (gi >= 0).float().reshape(-1)
        n = raw.shape[0]
        flat_g = torch.zeros((n,), dtype=torch.float32, device=raw.device)
        flat_h = torch.zeros((n,), dtype=torch.float32, device=raw.device)
        flat_g.index_add_(0, safe, g_pad.reshape(-1) * w)
        flat_h.index_add_(0, safe, h_pad.reshape(-1) * w)
        return flat_g[:, None], torch.clamp(flat_h, min=1e-3)[:, None]

    def value(self, raw, y):
        diff, pair_ok, _, _ = self._pairs(raw, y)
        losses = torch.logaddexp(torch.zeros_like(diff), -diff) * pair_ok
        return losses.sum() / torch.clamp(pair_ok.sum(), min=1.0)

    def metric(self, raw, y):
        """Pairwise ranking accuracy (fraction of correctly ordered
        pairs)."""
        _, pair_ok, s, _ = self._pairs(raw, y)
        correct = (s[:, :, None] > s[:, None, :]).float() * pair_ok
        return correct.sum() / torch.clamp(pair_ok.sum(), min=1.0)


def make_loss(name: str, *, n_classes: int = 2,
              group_index: Optional[np.ndarray] = None,
              alpha: float = 0.5) -> Loss:
    name = name.lower()
    if name == "rmse":
        return RMSE()
    if name == "mae":
        return MAE()
    if name == "quantile":
        return Quantile(alpha=alpha)
    if name == "logloss":
        return LogLoss()
    if name == "multiclass":
        return MultiClass(n_classes=n_classes)
    if name in ("pairlogit", "yetirank"):
        return PairLogitGrouped(group_index=group_index)
    raise ValueError(f"unknown loss {name!r}")
