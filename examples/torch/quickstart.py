"""Quickstart: train a CatBoost-style GBDT with the PyTorch port, build a
prediction plan, check the strategies against each other.

The port's counterpart of `examples/quickstart.py`, on the card unless
``--device cpu``.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

It exits 1 when the strategies disagree (MISMATCH).
"""
import argparse
import sys

import numpy as np

from repro_torch.core import boosting, losses
from repro_torch.core.boosting import BoostingParams
from repro_torch.core.predictor import PredictConfig, Predictor
from repro_torch.data import synthetic

MAX_DEVIATION = 1e-4    # staged vs fused raw scores


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--trees", type=int, default=80)
    args = ap.parse_args(argv)

    # Covertype-shaped synthetic data (54 features, 7 classes)
    ds = synthetic.load("covertype", scale=args.scale)
    loss = losses.make_loss("multiclass", n_classes=7)
    params = BoostingParams(n_trees=args.trees, depth=6, learning_rate=0.4)

    print(f"training on {ds.x_train.shape} on {args.device} ...")
    ens, hist = boosting.fit(ds.x_train, ds.y_train, loss=loss,
                             params=params, device=args.device)
    print(f"ensemble: {ens.describe()}")
    print(f"final train loss {hist['train_loss'][-1]:.4f} "
          f"metric {hist['final_metric']:.4f}")

    # Build the plan once (auto resolved to a concrete strategy, backend
    # and layout for the device, the model lowered once); every predict
    # reuses it.
    plan = Predictor.build(ens, device=args.device)
    print(f"plan: {plan.config}")

    pred = plan.classify(ds.x_test).cpu().numpy()
    acc = float((pred == ds.y_test).mean())
    print(f"test accuracy: {acc:.4f}")

    # Quantize once, score many: binarize the batch a single time into a
    # uint8 pool; every later predict skips binarization.
    pool = plan.quantize(ds.x_test)
    pool_pred = plan.classify(pool).cpu().numpy()
    same = bool(np.array_equal(pred, pool_pred))
    print(f"quantized pool: bins {tuple(pool.bins.shape)} {pool.bins.dtype}, "
          f"schema {pool.fingerprint}, float==pool predictions: {same}")

    # the strategies must agree (the paper's x86-vs-RISC-V parity check)
    staged = Predictor.build(ens, PredictConfig(strategy="staged"),
                             device=args.device)
    fused = Predictor.build(ens, PredictConfig(strategy="fused"),
                            device=args.device)
    x64 = ds.x_test[:64]
    err = float((staged.raw(x64) - fused.raw(x64)).abs().max())
    print(f"staged vs fused max deviation: {err:.2e}  "
          f"({'OK' if err < MAX_DEVIATION else 'MISMATCH'})")
    return {"accuracy": acc, "float_equals_pool": same,
            "staged_vs_fused": err}


if __name__ == "__main__":
    sys.exit(0 if main()["staged_vs_fused"] < MAX_DEVIATION else 1)
