"""End-to-end serving demo: a GBDT model served with batched requests
(the paper's speedup exists only for batched prediction; this is the
production shape of that finding).

The port's counterpart of `examples/serve_gbdt.py`, on the card unless
``--device cpu``.  Concurrent clients hit the deadline batcher; flushed
batches are padded to power-of-two buckets, so the plan sees at most one
new shape a bucket.  The server builds one `Predictor` from a
`PredictConfig`: --strategy fused runs the one-pass fused kernel.

Run:  PYTHONPATH=src python examples/torch/serve_gbdt.py [--device cpu]
"""
import argparse
import json
import threading
import time

import numpy as np

from repro_torch.core import boosting, losses
from repro_torch.core.boosting import BoostingParams
from repro_torch.core.predictor import PredictConfig
from repro_torch.data import synthetic
from repro_torch.kernels import registry
from repro_torch.serving.engine import GBDTServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--strategy", choices=["auto", "staged", "fused"],
                    default="auto")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", *registry.known_backends()])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--per-client", type=int, default=25)
    ap.add_argument("--trees", type=int, default=100)
    args = ap.parse_args(argv)

    ds = synthetic.load("santander", scale=0.004)
    loss = losses.make_loss("logloss")
    ens, _ = boosting.fit(ds.x_train, ds.y_train, loss=loss,
                          params=BoostingParams(n_trees=args.trees, depth=2,
                                                learning_rate=0.1),
                          device=args.device, backend=args.backend)
    config = PredictConfig(strategy=args.strategy, backend=args.backend)
    server = GBDTServer(ens, config=config, device=args.device,
                        max_batch=128, max_wait_ms=3.0, name="santander")
    print(f"plan: {server.config} on {server.predictor.device} "
          f"buckets={server.buckets}")

    n_clients, per_client = args.clients, args.per_client
    lat: list[float] = []
    lock = threading.Lock()

    def client(cid):
        rng = np.random.default_rng(cid)
        for _ in range(per_client):
            x = ds.x_test[rng.integers(0, len(ds.x_test))]
            t0 = time.perf_counter()
            server.batcher.submit(cid, x).get(timeout=30)
            with lock:
                lat.append(time.perf_counter() - t0)

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        server.close()
    n = n_clients * per_client

    lat_ms = np.asarray(lat) * 1e3
    sizes = server.batcher.batch_sizes
    snap = server.metrics.snapshot()
    p50, p99 = np.percentile(lat_ms, 50), np.percentile(lat_ms, 99)
    print(f"served {n} requests in {wall:.2f}s ({n / wall:.0f} req/s)")
    print(f"latency p50={p50:.1f}ms p99={p99:.1f}ms")
    print(f"batches formed: {len(sizes)}, mean size "
          f"{np.mean(sizes):.1f} (batching amortizes the vector width)")
    print(f"bucket usage: {server.batcher.bucket_counts}; "
          f"first calls={snap['recompiles']} "
          f"(bounded by {len(server.buckets)} buckets)")
    print(f"server metrics: {json.dumps(snap, default=float)}")
    return {"requests": n, "answered": len(lat), "req_per_s": n / wall,
            "p50_ms": p50, "p99_ms": p99,
            "first_calls": snap["recompiles"],
            "buckets": len(server.buckets)}


if __name__ == "__main__":
    main()
