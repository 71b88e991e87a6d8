"""Inputs made from the seed, on the device, in a few large calls.

One `torch.Generator` on the run's first device, seeded with the run's
seed, draws everything in a fixed order, so a seed gives the same inputs on
the same kind of device.  The program and the reference are handed the
same tensors (or their host copies).
"""
from __future__ import annotations

import torch

SEED_MOD = 2 ** 63


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % SEED_MOD)
    return g


def ensemble_arrays(cfg: dict, g: torch.Generator, device) -> dict:
    """A random oblivious ensemble of the configuration's published sizes:
    `trees` trees of `depth` over `features` features with `border_count`
    sorted normal borders each, `n_outputs` outputs, leaf values normal
    with standard deviation `leaf_scale` (so the raw scores' spread is
    about one whatever the tree count), a small normal base score."""
    t, d, f = cfg["trees"], cfg["depth"], cfg["features"]
    b, c = cfg["border_count"], cfg["n_outputs"]
    leaf_scale = cfg["leaf_scale"]
    return {
        "split_features": torch.randint(0, f, (t, d), generator=g,
                                        device=device, dtype=torch.int32),
        "split_bins": torch.randint(1, b + 1, (t, d), generator=g,
                                    device=device, dtype=torch.int32),
        "leaf_values": torch.randn((t, 1 << d, c), generator=g,
                                   device=device) * leaf_scale,
        "borders": torch.sort(torch.randn((b, f), generator=g,
                                          device=device), dim=0).values,
        "n_borders": torch.full((f,), b, dtype=torch.int32, device=device),
        "base_score": torch.randn((c,), generator=g, device=device) * 0.1,
    }


def rows(n: int, n_features: int, nan_share: float, g: torch.Generator,
         device) -> torch.Tensor:
    """(n, F) float32 standard normal rows, `nan_share` of the values NaN."""
    x = torch.randn((n, n_features), generator=g, device=device)
    x[torch.rand((n, n_features), generator=g, device=device)
      < nan_share] = torch.nan
    return x


def labelled_rows(n: int, cfg: dict, g: torch.Generator, device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, F) rows and (n,) int32 class ids: uniform classes, each row its
    class's mean plus unit noise, the means normal on `informative_share`
    of the features and 0 on the rest; `nan_share` of the values NaN."""
    f, c = cfg["features"], cfg["n_outputs"]
    y = torch.randint(0, c, (n,), generator=g, device=device,
                      dtype=torch.int32)
    informative = torch.rand((f,), generator=g, device=device) \
        < cfg["informative_share"]
    means = torch.randn((c, f), generator=g, device=device) * informative
    x = means[y.long()] + rows(n, f, cfg["nan_share"], g, device)
    return x, y


def quantile_borders(x: torch.Tensor, count: int) -> torch.Tensor:
    """(count, F) borders: the values at `count` evenly spaced interior
    ranks of each feature's finite values (no interpolation)."""
    finite = torch.isfinite(x)
    xs = torch.sort(torch.where(finite, x, torch.inf), dim=0).values
    n_fin = finite.sum(0)                                       # (F,)
    q = torch.arange(1, count + 1, device=x.device, dtype=torch.float64) \
        / (count + 1)
    pos = (q[:, None] * (n_fin[None, :] - 1).double()).long()   # (B, F)
    return torch.gather(xs, 0, pos)
