"""The paper's image-embeddings workload with the PyTorch port: backbone
embeddings -> kNN features (the L2SqrDistance hotspot) -> GBDT multiclass
head.

The port's counterpart of `examples/embeddings_knn.py`, on the card
unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch/embeddings_knn.py [--device cpu]
"""
import argparse

from repro_torch.core import boosting, knn, losses, predict
from repro_torch.core.boosting import BoostingParams
from repro_torch.data import synthetic
from repro_torch.serving.engine import EmbeddingGBDTPipeline


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--trees", type=int, default=120)
    args = ap.parse_args(argv)

    ds = synthetic.load("image_embeddings", scale=args.scale)
    print(f"embeddings: train {ds.emb_train.shape} test {ds.emb_test.shape}")

    feat = knn.KNNFeaturizer(ds.emb_train, ds.y_train,
                             n_classes=ds.n_classes, k=16,
                             device=args.device)
    x_train = knn.augment_with_knn(ds.x_train, ds.emb_train, feat)
    print(f"augmented features: {x_train.shape} "
          f"(+{feat.n_features} KNN features)")

    loss = losses.make_loss("multiclass", n_classes=ds.n_classes)
    params = BoostingParams(n_trees=args.trees, depth=4, learning_rate=0.1)
    ens, _ = boosting.fit(x_train, ds.y_train, loss=loss, params=params,
                          device=args.device)

    pipeline = EmbeddingGBDTPipeline(feat, ens, device=args.device)
    pred = pipeline.predict(ds.emb_test)
    acc = float((pred == ds.y_test).mean())
    print(f"test accuracy: {acc:.4f} (paper reports 0.802 on real VOC)")

    # baseline without KNN features, for the ablation
    ens0, _ = boosting.fit(ds.x_train, ds.y_train, loss=loss, params=params,
                           device=args.device)
    pred0 = predict.predict_class(ens0, ds.x_test, device=args.device)
    acc0 = float((pred0.cpu().numpy() == ds.y_test).mean())
    print(f"without KNN features: {acc0:.4f}")
    return {"accuracy": acc, "accuracy_without_knn": acc0}


if __name__ == "__main__":
    main()
